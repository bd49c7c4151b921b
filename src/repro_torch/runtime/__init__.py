"""Grid-mining runtime: the mining algorithms (``repro_torch.core``)
executed through the grid workflow model (``repro_torch.workflow``) on one
device, with measured kernel time calibrating the simulated grid clock.
``ResultCache`` is the mining service's versioned result cache
(``launch.serve``): keys carry the dataset version, so stale results are
unreachable by construction.
"""

from repro_torch.runtime.cache import CacheStats, ResultCache, params_key
from repro_torch.runtime.gridruntime import FusedRun, GridRuntime, RuntimeRun

__all__ = ["CacheStats", "FusedRun", "GridRuntime", "ResultCache", "RuntimeRun", "params_key"]
