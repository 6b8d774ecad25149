from repro_torch.ft.elastic import elastic_meshes, reshard_tree
from repro_torch.ft.failures import FailureInjector, SimulatedFailure
from repro_torch.ft.watchdog import StepWatchdog

__all__ = ["FailureInjector", "SimulatedFailure", "StepWatchdog",
           "elastic_meshes", "reshard_tree"]
