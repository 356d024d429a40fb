"""Host-side logic of the attention and scan wrappers, on the CPU: which
kernel a dtype takes, the checks a wrapper applies before it reaches for a
library, the tile plans' shared memory, and the flags and plan a launch
hands the library (through a stand-in library that records the call). The
calls end (..., flags, smem plan, stream), so they are read from the
end."""
import pytest
import torch

from repro_torch.kernels import flash_attention as fkern
from repro_torch.kernels import mamba_scan as mk

SMEM_LIMIT = 232_448   # bytes of shared memory one block may use on Hopper


class _Recorder:
    """Stands in for a loaded kernel library: records each call."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def fn(*args):
            self.calls.append((name, args))
            return 0
        return fn


class _Untouchable:
    def __getattr__(self, name):
        raise AssertionError(f"the wrapper reached for the library ({name})")


@pytest.fixture
def recorder(monkeypatch):
    lib = _Recorder()
    for mod in (fkern, mk):
        monkeypatch.setattr(mod, "_library", lambda *a: lib)
        monkeypatch.setattr(mod, "_stream", lambda device: 0)
    return lib


@pytest.fixture
def untouchable(monkeypatch):
    for mod in (fkern, mk):
        monkeypatch.setattr(mod, "_library", lambda *a: _Untouchable())
        monkeypatch.setattr(mod, "_stream", lambda device: 0)


def _prefill_view(b, s, heads, d, dtype, pad=0):
    """A [B, S, heads, D + pad] buffer's first D columns, viewed as
    [B, heads, S, D], as the prefill hands its projections in."""
    return torch.zeros(b, s, heads, d + pad, dtype=dtype)[..., :d].transpose(
        1, 2)


@pytest.mark.parametrize("dtype,source", [
    (torch.bfloat16, "flash_attention_sm90"),
    (torch.float32, "flash_attention")])
def test_flash_source_follows_dtype(dtype, source):
    assert fkern.source_for(dtype) == source


def test_flash_source_refuses_other_dtypes():
    with pytest.raises(TypeError, match="float16"):
        fkern.source_for(torch.float16)


@pytest.mark.parametrize("head_dim,expected", [(64, 83_072),
                                               (128, 164_992)])
def test_flash_smem_plan_fits_a_block(head_dim, expected):
    """The numbers csrc/flash_attention_sm90.cu's header states."""
    assert fkern.sm90_smem_bytes(head_dim) == expected <= SMEM_LIMIT


@pytest.mark.parametrize("dtype,expected", [(torch.float32, 36_864),
                                            (torch.bfloat16, 20_480)])
def test_scan_smem_plan_fits_without_opting_in(dtype, expected):
    """csrc/mamba_scan.cu's header: under the 48 KB a launch may take
    without raising its limit (the kernel asserts so)."""
    assert mk.smem_bytes(dtype) == expected <= 48 * 1024 <= SMEM_LIMIT


@pytest.mark.parametrize("b,h,kv,s,d", [(1, 40, 8, 300, 128),
                                        (2, 32, 32, 77, 64)])
def test_flash_bf16_launches_the_tensor_core_kernel(recorder, b, h, kv, s, d):
    q = _prefill_view(b, s, h, d, torch.bfloat16)
    k, v = (_prefill_view(b, s, kv, d, torch.bfloat16) for _ in range(2))
    before = fkern.launches["flash_attention"]
    out = fkern._launch(q, k, v, True, None)
    assert fkern.launches["flash_attention"] == before + 1
    ((name, args),) = recorder.calls
    assert name == "flash_attention_sm90_fwd"
    assert args[-2] == fkern.sm90_smem_bytes(d)
    assert out.stride() == q.stride()   # the output keeps q's layout


def test_flash_f32_launches_the_simt_kernel(recorder):
    q = _prefill_view(1, 50, 8, 64, torch.float32)
    k, v = (_prefill_view(1, 50, 2, 64, torch.float32) for _ in range(2))
    fkern._launch(q, k, v, False, 16)
    ((name, args),) = recorder.calls
    assert name == "flash_attention_fwd"
    assert args[-3:-1] == (1, 1)   # 16-byte row loads for q and for k, v


def test_flash_f32_takes_a_misaligned_view(recorder):
    """The SIMT kernel loads element by element where rows are not
    16-byte aligned; only the bf16 kernel needs TMA's alignment."""
    q = _prefill_view(1, 50, 8, 64, torch.float32, pad=1)
    fkern._launch(q, q[:, :2], q[:, :2], True, None)
    ((name, args),) = recorder.calls
    assert name == "flash_attention_fwd" and args[-3:-1] == (0, 0)


@pytest.mark.parametrize("case", ["row stride", "start", "head stride"])
def test_flash_bf16_alignment_is_checked_before_the_library(untouchable,
                                                            case):
    if case == "row stride":     # rows 68 elements (136 bytes) apart
        q = _prefill_view(1, 16, 1, 64, torch.bfloat16, pad=4)
    elif case == "start":        # one element past a 16-byte boundary
        q = torch.zeros(1 * 1 * 16 * 64 + 1, dtype=torch.bfloat16)[1:].view(
            1, 1, 16, 64)
    else:                        # heads 72 elements apart
        q = torch.zeros(2 * 16 * 72, dtype=torch.bfloat16).as_strided(
            (1, 2, 16, 64), (2 * 16 * 72, 36, 72, 1))
    before = fkern.launches["flash_attention"]
    with pytest.raises(ValueError, match="TMA"):
        fkern._launch(q, q[:, :1], q[:, :1], True, None)
    assert fkern.launches["flash_attention"] == before


def test_tma_strides_skip_dimensions_of_size_one():
    """A size-1 dimension is never stepped: its stride may be anything,
    and the map is given a contiguous tensor's."""
    base = torch.zeros(2 * 4 * 32 * 64, dtype=torch.bfloat16)
    strides = (3, 32 * 64, 64, 1)
    q = base.as_strided((1, 4, 32, 64), strides)
    assert fkern.tma_strides("q", q) == (4 * 32 * 64, 32 * 64, 64)
    with pytest.raises(ValueError, match="TMA"):
        fkern.tma_strides("q", base.as_strided((2, 4, 32, 64), strides))


def _scan_args(b, s, di, n, x_dtype, bc_dtype, dtr=16):
    """Inputs as ``mamba1_seq`` hands them in: B and C column views of a
    [B, S, dtr + 2N] projection."""
    x = torch.zeros(b, s, di, dtype=x_dtype)
    proj = torch.zeros(b, s, dtr + 2 * n, dtype=bc_dtype)
    return (x, torch.zeros(b, s, di, dtype=x_dtype),
            torch.zeros(di, n), proj[..., dtr:dtr + n], proj[..., dtr + n:])


@pytest.mark.parametrize("args,vec", [
    # falcon-mamba-7b's prefill (dt_rank 256, N 16), f32 and bf16
    (_scan_args(1, 64, 8192, 16, torch.float32, torch.float32, 256), (1, 1)),
    (_scan_args(1, 64, 8192, 16, torch.bfloat16, torch.bfloat16, 256),
     (1, 1)),
    # a row of 1004 bf16 channels, or of 5 states, ends inside a chunk;
    # a C view 26 f32 columns in starts off a 16-byte boundary
    (_scan_args(2, 9, 1004, 16, torch.bfloat16, torch.bfloat16), (0, 1)),
    (_scan_args(1, 9, 64, 5, torch.float32, torch.float32), (1, 0)),
    (_scan_args(1, 9, 64, 10, torch.float32, torch.float32), (1, 0)),
])
def test_scan_launch_flags_and_plan(recorder, args, vec):
    y, h = mk._launch(*args)
    ((name, call),) = recorder.calls
    assert name == "mamba_scan_fwd"
    assert call[-4:-2] == vec
    assert call[-2] == mk.smem_bytes(args[0].dtype)
    b, s, di = args[0].shape
    assert y.dtype == args[0].dtype and h.shape == (b, di, args[2].shape[1])


@pytest.mark.parametrize("x_dtype,dt_dtype,b_dtype,c_dtype", [
    (torch.bfloat16, torch.float32, torch.bfloat16, torch.bfloat16),
    (torch.bfloat16, torch.bfloat16, torch.float32, torch.bfloat16),
    (torch.float32, torch.float32, torch.bfloat16, torch.bfloat16),
    (torch.bfloat16, torch.bfloat16, torch.bfloat16, torch.float32),
])
def test_scan_widens_a_mix_of_dtypes_to_f32(recorder, x_dtype, dt_dtype,
                                            b_dtype, c_dtype):
    """The kernel takes x, dt, B and C in one dtype: a mix goes as f32
    (exact), planned as f32; y keeps x's dtype."""
    x, dt, A, Bm, Cm = _scan_args(1, 9, 64, 16, torch.float32,
                                  torch.float32)
    y, _ = mk._launch(x.to(x_dtype), dt.to(dt_dtype), A, Bm.to(b_dtype),
                      Cm.to(c_dtype))
    ((_, call),) = recorder.calls
    assert call[-2] == mk.smem_bytes(torch.float32)
    assert y.dtype == x_dtype


@pytest.mark.parametrize("n,dtype,error", [
    (0, torch.float32, ValueError), (17, torch.float32, ValueError),
    (16, torch.float16, TypeError)])
def test_scan_inputs_are_checked_before_the_library(untouchable, n, dtype,
                                                    error):
    x, dt, A, Bm, Cm = _scan_args(1, 9, 64, max(n, 1), torch.float32,
                                  torch.float32)
    if n == 0:
        A, Bm, Cm = A[:, :0], Bm[..., :0], Cm[..., :0]
    before = mk.launches["mamba_scan"]
    with pytest.raises(error):
        mk._launch(x.to(dtype), dt, A, Bm, Cm)
    assert mk.launches["mamba_scan"] == before


@pytest.mark.parametrize("shape,stride,offset,want", [
    ((1, 64, 8192), None, 0, True),
    ((1, 64, 8192), None, 1, False),      # start off a 16-byte boundary
    ((2, 64, 1002), None, 0, False),      # rows end inside a chunk
    ((1, 64, 16), (5, 288, 1), 0, True),  # size-1 batch: its stride unused
    ((2, 64, 16), (5, 288, 1), 0, False),
])
def test_copies16(shape, stride, offset, want):
    n = 2 * 64 * 8192 + 8
    base = torch.zeros(n)[offset:]
    t = (base[:torch.Size(shape).numel()].view(shape) if stride is None
         else base.as_strided(shape, stride))
    assert mk.copies16(t) is want
