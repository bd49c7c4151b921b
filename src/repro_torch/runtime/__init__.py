"""Grid-mining runtime: the mining algorithms (``repro_torch.core``)
executed through the grid workflow model (``repro_torch.workflow``) on one
device, with measured kernel time calibrating the simulated grid clock.
"""

from repro_torch.runtime.gridruntime import GridRuntime, RuntimeRun

__all__ = ["GridRuntime", "RuntimeRun"]
