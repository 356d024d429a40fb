"""The port's CUDA kernels on the card: each against its plain PyTorch
version, and the fused path of a local step reaching them. Needs a CUDA
device and ``nvcc``; without a card every test here skips. Run on the card
with ``python -m pytest -q tests/test_torch_cuda.py`` (no JAX needed)."""
import pytest
import torch

from repro_torch.kernels import ref, storm_update as kern

RTOL = 1e-6


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels are CUDA only)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _close(got, want):
    torch.cuda.synchronize()
    limit = RTOL * max(1.0, want.abs().max().item())
    assert (got - want).abs().max().item() <= limit


@pytest.mark.parametrize("m,n,offset", [(8, 4096, 0), (1, 1001, 0),
                                        (3, 3, 0), (2, 777, 1)])
def test_kernels_match_plain_versions(cuda, m, n, offset):
    g = torch.Generator(device=cuda)
    g.manual_seed(m * n)

    def buf(rows, cols):
        flat = torch.randn(rows * cols + offset, generator=g, device=cuda)
        return flat[offset:].view(rows, cols)
    gn, go, est, p, w = (buf(m, n) for _ in range(5))
    a = buf(1, n)[0].abs()
    beta = torch.full((), 0.3, device=cuda)
    lr, rho = torch.full((), 0.01, device=cuda), torch.full((), 1e-4,
                                                            device=cuda)
    before = dict(kern.launches)
    _close(kern.storm_update(gn, go, est, beta),
           ref.storm_update_ref(gn, go, est, beta))
    _close(kern.adafbio_update(p, w, a, lr, rho),
           ref.adafbio_update_ref(p, w, a, lr, rho))
    assert kern.launches["storm_update"] == before["storm_update"] + 1
    assert kern.launches["adafbio_update"] == before["adafbio_update"] + 1


def test_wrappers_reject_what_the_kernel_does_not_take(cuda):
    x = torch.ones(2, 8, device=cuda)
    beta = torch.full((), 0.5, device=cuda)
    with pytest.raises(TypeError, match="float32"):
        kern.storm_update(x.double(), x, x, beta)
    with pytest.raises(TypeError, match="one-element"):
        kern.storm_update(x, x, x, 0.5)
    with pytest.raises(ValueError, match="contiguous"):
        kern.storm_update(x.t().contiguous().t(), x, x, beta)
    with pytest.raises(ValueError, match="shape"):
        kern.adafbio_update(x, x, x, beta, beta)


def test_fused_auto_reaches_the_kernels(cuda):
    from repro_torch.configs import FedConfig
    from repro_torch.core import adafbio
    from repro_torch.core.bilevel import quadratic_bilevel_problem
    eye = torch.eye(4, device=cuda)
    prob = quadratic_bilevel_problem(eye, eye, torch.ones(4, device=cuda),
                                     eye)
    fed = FedConfig(q=2, neumann_k=3)
    m = 3
    states = {k: torch.randn(m, 4, device=cuda) for k in "xyvw"}
    adaptive = {"a": torch.ones(4, device=cuda),
                "b": torch.ones((), device=cuda)}
    zero = torch.zeros(m, device=cuda)
    batches = {"f": zero, "g": zero, "g0": zero,
               "gi": torch.zeros(m, 3, device=cuda)}
    kern.reset_launches()
    adafbio.local_step(prob, fed, states, adaptive, batches,
                       torch.tensor([0, 1, 2], device=cuda),
                       torch.zeros((), dtype=torch.int32, device=cuda), m)
    assert kern.launches == {"storm_update": 2, "adafbio_update": 1}
