from repro_torch.runtime.straggler import StragglerMonitor  # noqa: F401
from repro_torch.runtime.elastic import ElasticState, remesh_plan  # noqa: F401
from repro_torch.runtime.compression import (compressed_mean,  # noqa: F401
                                             ErrorFeedback)
