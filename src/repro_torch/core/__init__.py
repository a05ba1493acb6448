"""Apache VXQuery on PyTorch — the paper's contribution as a library.

Layers (paper Fig. 1): xqparser/translator (VXQuery front), algebra +
rewrite (Algebricks), physical/executor (Hyracks -> tensors with a
leading partition dimension, on the GPU unless the caller asks for
the CPU), and the serving tier on top (``QueryService``: prepared
queries, plan cache, regrowth, batching, the admission runtime)."""
from repro_torch.core import algebra, xdm  # noqa: F401
from repro_torch.core.errors import InvalidArgumentError  # noqa: F401
from repro_torch.core.executor import (ExecConfig, Executor,  # noqa: F401
                                       ResultSet)
from repro_torch.core.prepared import (ParamSpec,  # noqa: F401
                                       PreparedQuery, bind_params,
                                       lift_params, prepare_plan)
from repro_torch.core.rewrite import optimize  # noqa: F401
from repro_torch.core.service import (QueryOverflowError,  # noqa: F401
                                      QueryService, ServiceStats)
from repro_torch.core.serving import (AdmissionQueue,  # noqa: F401
                                      CostBasedBucketing, FairScheduler,
                                      Pow2Bucketing, ServingRuntime,
                                      Ticket, VirtualClock)
from repro_torch.core.translator import translate  # noqa: F401


def compile_query(query: str):
    """parse + normalize + optimize: query text -> physical-ready plan."""
    return optimize(translate(query))
