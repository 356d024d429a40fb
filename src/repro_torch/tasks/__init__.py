from repro_torch.tasks.driver import Draws, FedDriver, RunResult
from repro_torch.tasks.hyperclean import build_hyperclean
from repro_torch.tasks.hyperrep import build_hyperrep

__all__ = ["Draws", "FedDriver", "RunResult", "build_hyperclean",
           "build_hyperrep"]
