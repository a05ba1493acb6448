"""The LM stack of the port: layers, attention, the composable model and
its serve steps (dense blocks; ``mamba``, ``moe``, M-RoPE and the
non-token front ends wait for their own slices)."""
