"""Join probe kernel wrapper: ``csrc/hash_join.cu`` on a CUDA tensor.

Ports the Pallas TPU kernel ``src/repro/kernels/hash_join.py``
(``block_join_probe``). The kernel, its design and its bound are
described in the source; the plain version is ``ref.block_join_probe``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_ARGS = ([ctypes.c_void_p] * 8 + [ctypes.c_longlong] + [ctypes.c_int] * 5
         + [ctypes.c_void_p])


def table_slots(nb: int) -> int:
    """Hash-table slots per partition: the power of two >= 2 NB (load
    factor at most 1/2), from the build side's capacity, so no host sync
    counts its valid rows; 0 when NB is 0."""
    return 1 << (2 * nb - 1).bit_length() if nb else 0


def block_join_probe(build_keys: tuple[torch.Tensor, ...],
                     build_valid: torch.Tensor,
                     probe_keys: tuple[torch.Tensor, ...],
                     probe_valid: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """build keys [P, NB] int32 (1 or 2 columns) + valid [P, NB] bool,
    probe keys [P, NP] + valid [P, NP] -> (pos [P, NP] int32, the
    smallest matching build index or -1; matched [P, NP] bool).
    CUDA tensors only; raises on anything the kernel does not take.
    One call is one launch of the C entry point (table fill, build and
    probe kernels), with P x ``table_slots(NB)`` int32 of scratch."""
    nk = len(build_keys)
    if nk != len(probe_keys) or not 1 <= nk <= 2:
        raise ValueError("1 or 2 key columns on each side")
    dev = probe_valid.device
    if dev.type != "cuda":
        raise ValueError(f"block_join_probe kernel needs CUDA tensors, "
                         f"got {dev}")
    p, np_ = probe_valid.shape
    nb = build_valid.shape[1]
    for t, shape in [(k, (p, nb)) for k in build_keys] + \
            [(k, (p, np_)) for k in probe_keys]:
        if t.dtype != torch.int32 or tuple(t.shape) != shape \
                or t.device != dev:
            raise ValueError(f"join keys must be int32 {shape} on {dev}")
    if build_valid.dtype != torch.bool or probe_valid.dtype != torch.bool \
            or build_valid.shape[0] != p or build_valid.device != dev:
        raise ValueError("join valid masks must be bool [P, N] on one device")
    bk = [k.contiguous() for k in build_keys]
    pk = [k.contiguous() for k in probe_keys]
    bv, pv = build_valid.contiguous(), probe_valid.contiguous()
    pos = torch.empty((p, np_), dtype=torch.int32, device=dev)
    # scratch on the current stream through the caching allocator; the
    # launcher fills it
    tsize = table_slots(nb)
    table = torch.empty(p * tsize, dtype=torch.int32, device=dev)
    fn = _build.function("hash_join", "repro_join_probe", _ARGS)
    code = fn(pk[0].data_ptr(), pk[-1].data_ptr(), pv.data_ptr(),
              bk[0].data_ptr(), bk[-1].data_ptr(), bv.data_ptr(),
              pos.data_ptr(), table.data_ptr(), tsize, p, np_, nb,
              int(nk == 2), dev.index or 0, _build.stream(dev))
    _build.check("hash_join", "block_join_probe", code)
    block_join_probe.launches += 1
    return pos, pos >= 0


block_join_probe.launches = 0
