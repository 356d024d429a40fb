"""Host-side logic of the attention and scan wrappers, on the CPU: which
kernel a dtype takes, the checks a wrapper applies before it reaches for a
library, the tile plans' shared memory, the int8 decode's work split, and
the flags and plan a launch hands the library (through a stand-in library
that records the call). The calls end (..., flags, smem plan, stream), so
they are read from the end."""
import hypothesis.strategies as st
import pytest
import torch
from hypothesis import given, settings

from repro_torch.kernels import flash_attention as fkern
from repro_torch.kernels import mamba_scan as mk
from repro_torch.kernels import quant_decode as qd

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


SM_COUNT = 132         # an H100 SXM's SMs


@pytest.fixture
def recorder(monkeypatch):
    lib = _Recorder()
    for mod in (fkern, mk, qd):
        monkeypatch.setattr(mod, "_library", lambda *a: lib)
        monkeypatch.setattr(mod, "_stream", lambda device: 0)
    monkeypatch.setattr(qd, "_sm_count", lambda device: SM_COUNT)
    return lib


@pytest.fixture
def untouchable(monkeypatch):
    for mod in (fkern, mk, qd):
        monkeypatch.setattr(mod, "_library", lambda *a: _Untouchable())
        monkeypatch.setattr(mod, "_stream", lambda device: 0)
    monkeypatch.setattr(qd, "_sm_count", lambda device: SM_COUNT)


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


# ------------------------------------------------ the int8 decode's plan

W = 2048               # the serve pool's window (chip_smoke.py)
# rows at the edges of a tile and of the cache: empty (0: every slot
# masked, all W slots walked), 1, 63-65, W, past W
EDGE_POS = (0, 1, 63, 64, 65, W - 1, W, W + 1, 5 * W)


def _check_split(pos, kv, w, n_blocks):
    """The device's work split covers every (row, kv head, tile) once, in
    order; no share exceeds ceil(T / blocks) + 1 tiles; the kernel's
    block_of finds each task's block; every block from the first to the
    last of a (row, kv head) holds part of it (the kernel merges that many
    parts); and the parts get distinct partial records (block + row * KV +
    kv head)."""
    tiles = qd.row_tiles(pos, w)
    want = [(b, h, j) for b, n in enumerate(tiles) for h in range(kv)
            for j in range(n)]
    shares = qd.shares(pos, kv, w, n_blocks)
    assert len(shares) == n_blocks
    assert [t for share in shares for t in share] == want
    total = len(want)
    assert max(map(len, shares)) <= -(-total // n_blocks) + 1
    t = 0
    records = set()
    for i, share in enumerate(shares):
        for b, h, _ in share:
            assert qd.block_of(t, total, n_blocks) == i
            records.add((i, b * kv + h))
            t += 1
    assert len({i + pair for i, pair in records}) == len(records)
    for pair in {p for _, p in records}:
        blocks = sorted(i for i, p in records if p == pair)
        assert blocks == list(range(blocks[0], blocks[-1] + 1))


@pytest.mark.parametrize("pos", [
    (1, 2048, 1000, 1536, 37, 2047, 512, 1300),   # chip_smoke.py's main
    EDGE_POS[:8],
    (0,) * 8,                                      # all rows empty
    (1,) * 8,
    (W,) * 8,
    (1, 1, 1, W, 1, 1, 1, 1),                      # one long row
])
@pytest.mark.parametrize("kv,n_blocks", [(8, 264), (1, 26), (8, 7),
                                         (2, 1)])
def test_decode_split_covers_every_tile_once(pos, kv, n_blocks):
    _check_split(pos, kv, W, n_blocks)


@settings(max_examples=200, deadline=None)
@given(st.lists(st.one_of(st.sampled_from(EDGE_POS),
                          st.integers(-3, 3 * W)), min_size=1, max_size=12),
       st.integers(1, 8), st.integers(1, 300),
       st.sampled_from([W, 2000, 64, 65, 1]))
def test_decode_split_property(pos, kv, n_blocks, w):
    _check_split(pos, kv, w, n_blocks)


def test_decode_split_balances_the_main_case():
    """chip_smoke.py's main case (bf16): 1,080 tasks over 396 blocks, at
    most 3 tiles a block where PR 13's split walked 7 in series."""
    pos = (1, 2048, 1000, 1536, 37, 2047, 512, 1300)
    n_blocks = qd.grid_blocks(8, 8, W, 1, SM_COUNT, torch.bfloat16)
    shares = qd.shares(pos, 8, W, n_blocks)
    assert n_blocks == 396 and sum(map(len, shares)) == 1080
    assert max(map(len, shares)) == 3


@pytest.mark.parametrize("g,dtype,want", [
    (1, torch.float32, (1, 1)), (5, torch.float32, (1, 5)),
    (6, torch.float32, (2, 3)), (8, torch.float32, (2, 4)),
    (48, torch.float32, (10, 5)), (512, torch.float32, (103, 5)),
    (5, torch.bfloat16, (1, 5)), (8, torch.bfloat16, (1, 8)),
    (9, torch.bfloat16, (2, 5)), (48, torch.bfloat16, (6, 8)),
    (7, torch.bfloat16, (1, 7))])
def test_decode_head_passes(g, dtype, want):
    passes, gc = qd.head_passes(g, dtype)
    assert (passes, gc) == want
    assert gc <= qd.GROUP[dtype] and gc * (passes - 1) < g <= gc * passes


@pytest.mark.parametrize("head_dim,dtype,want", [
    (128, torch.float32, 652), (64, torch.float32, 332),
    (128, torch.bfloat16, 1040), (64, torch.bfloat16, 528)])
def test_decode_partial_records_are_whole_float4s(head_dim, dtype, want):
    """The last block merges the records with float4 loads."""
    assert qd.record_floats(head_dim, dtype) == want and want % 4 == 0


@pytest.mark.parametrize("b,kv,s,passes,dtype,want", [
    (8, 8, 2048, 1, torch.bfloat16, 396),  # the serve pool: 3 blocks an SM
    (8, 8, 2048, 1, torch.float32, 264),   # f32: 2 blocks an SM
    (4, 1, 2048, 6, torch.bfloat16, 66),   # MQA at g 48: six passes
    (4, 1, 2048, 10, torch.float32, 26),   # ten in f32
    (2, 2, 100, 1, torch.bfloat16, 8),     # no more blocks than tiles
    (1, 1, 64, 103, torch.float32, 1),
])
def test_decode_grid_is_fixed_by_host_sizes(b, kv, s, passes, dtype, want):
    assert qd.grid_blocks(b, kv, s, passes, SM_COUNT, dtype) == want


@pytest.mark.parametrize("head_dim,dtype,expected", [
    (128, torch.bfloat16, 73_544), (128, torch.float32, 68_840),
    (64, torch.bfloat16, 37_704), (64, torch.float32, 35_304)])
@pytest.mark.parametrize("g", [1, 5, 8, 48])
def test_decode_smem_plan_fits_a_block(head_dim, dtype, expected, g):
    """At the serve path's 8 rows: three stages of int8 K and V tiles with
    their scales and a pass's q rows, the warps' merge area and the rows'
    positions. The plan holds GROUP heads whatever g is (larger groups take
    more passes), so every g fits, and BLOCKS_PER_SM blocks share an SM's
    228 KB (each with 1 KB the card keeps)."""
    assert qd.head_passes(g, dtype)[1] <= qd.GROUP[dtype]
    assert qd.smem_bytes(head_dim, dtype, 8) == expected <= qd.SMEM_LIMIT
    assert qd.BLOCKS_PER_SM[dtype] * (expected + 1024) <= 228 * 1024


def _decode_args(b, h, kv, w, d, dtype=torch.bfloat16, offset=0):
    """q and one layer's [B, W, KV, Dh] pool slice viewed as [B, KV, W,
    Dh], as the decode hands them in; ``offset`` moves the levels off a
    16-byte boundary."""
    q = torch.zeros(b, h, d, dtype=dtype)
    n = b * w * kv * d

    def levels():
        return torch.zeros(n + offset, dtype=torch.int8)[offset:].view(
            b, w, kv, d).transpose(1, 2)
    scales = torch.ones(b, w, kv).transpose(1, 2)
    return q, levels(), scales, levels(), scales


@pytest.mark.parametrize("b,h,kv,w,d,dtype,offset", [
    (8, 40, 8, 2048, 128, torch.bfloat16, 0),   # qwen2.5-14b's decode
    (4, 48, 1, 2048, 128, torch.bfloat16, 0),   # MQA: six passes
    (2, 8, 2, 100, 64, torch.float32, 1),       # misaligned levels
])
def test_decode_launch_hands_the_library_its_plan(recorder, b, h, kv, w, d,
                                                  dtype, offset):
    """One call with the fixed grid, the counters' and scratch pointers
    and the alignment flags; the counters are the device's own buffer."""
    args = _decode_args(b, h, kv, w, d, dtype, offset)
    pos = torch.arange(1, b + 1, dtype=torch.int64) * 37
    before = qd.launches["quant_decode_attention"]
    out = qd._launch(*args, pos)
    assert qd.launches["quant_decode_attention"] == before + 1
    assert out.shape == (b, h, d) and out.dtype == dtype
    ((name, call),) = recorder.calls
    assert name == "quant_decode_attention"
    passes, gc = qd.head_passes(h // kv, dtype)
    n_blocks = qd.grid_blocks(b, kv, w, passes, SM_COUNT, dtype)
    assert call[10:19] == (n_blocks, passes, gc, fkern.DTYPES[dtype], b, h,
                           kv, w, d)
    assert call[6] == 1                      # one position a row
    counters = qd._counters(torch.device("cpu"), passes * b * kv)
    assert call[9] == counters.data_ptr()
    assert counters.numel() >= passes * b * kv and not counters.any()
    assert call[8] not in (0, call[9])       # the partials' scratch
    assert call[-3:-1] == (int(offset == 0), 1)


def test_decode_scalar_position_is_read_by_every_row(recorder):
    qd._launch(*_decode_args(2, 8, 2, 100, 64, torch.float32), 7)
    ((_, call),) = recorder.calls
    assert call[6] == 0                      # stride 0: one shared position


@pytest.mark.parametrize("case,error,match", [
    ("q dtype", TypeError, "float16"),
    ("level dtype", TypeError, "int8"),
    ("scale shape", ValueError, "scales"),
    ("pos shape", ValueError, "pos"),
    ("head_dim", ValueError, "head_dim"),
    ("rows", ValueError, "shared memory"),
])
def test_decode_refusals_come_before_the_library(untouchable, case, error,
                                                 match):
    # 25,000 rows' positions and task starts overflow a block's shared
    # memory
    b, h = (25_000, 2) if case == "rows" else (2, 8)
    q, k8, ks, v8, vs = _decode_args(b, h, 2, 16, 64, torch.float32)
    pos = 3
    if case == "q dtype":
        q = q.half()
    elif case == "level dtype":
        k8 = k8.float()
    elif case == "scale shape":
        ks = ks[:, :, :8]
    elif case == "pos shape":
        pos = torch.ones(b + 1, dtype=torch.int32)
    elif case == "head_dim":
        q, k8, ks, v8, vs = _decode_args(b, 8, 2, 16, 96, torch.float32)
    before = qd.launches["quant_decode_attention"]
    with pytest.raises(error, match=match):
        qd._launch(q, k8, ks, v8, vs, pos)
    assert qd.launches["quant_decode_attention"] == before
