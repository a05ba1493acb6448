from repro_torch.core.baselines.saxon_like import SaxonLike  # noqa: F401
from repro_torch.core.baselines.mrql_like import MrqlLike  # noqa: F401
