from repro_torch.tasks.driver import Draws, FedDriver, RunResult
from repro_torch.tasks.hyperrep import build_hyperrep

__all__ = ["Draws", "FedDriver", "RunResult", "build_hyperrep"]
