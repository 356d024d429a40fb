"""The port's CUDA kernels on the card: each against its plain PyTorch
version, and the fused path of a local step, the int8 codec and the serve
engine reaching them. Needs a CUDA device and ``nvcc``; without a card every
test here skips. Run on the card with ``python -m pytest -q tests/test_torch_cuda.py``
(no JAX needed)."""
import pytest
import torch

from repro_torch.core.tree_util import tree_leaves, tree_map
from repro_torch.kernels import quantize as qkern, ref
from repro_torch.kernels import storm_update as kern

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


@pytest.mark.parametrize("m,n,offset", [(8, 4096, 0), (1, 1001, 0),
                                        (3, 3, 0), (2, 777, 1), (4, 1024, 1)])
def test_per_row_adafbio_matches_plain_version(cuda, m, n, offset):
    """``a`` as [M, n], one accumulator row per client row (the gossip
    engine's nodes): one launch, held to the plain version and, bit for bit,
    to a loop of the shared-row kernel over the rows."""
    g = torch.Generator(device=cuda)
    g.manual_seed(m * n + 1)

    def buf(rows, cols):
        flat = torch.randn(rows * cols + offset, generator=g, device=cuda)
        return flat[offset:].view(rows, cols)
    p, w = buf(m, n), buf(m, n)
    a = buf(m, n).abs()
    lr, rho = torch.full((), 0.01, device=cuda), torch.full((), 1e-4,
                                                            device=cuda)
    before = kern.launches["adafbio_update"]
    got = kern.adafbio_update(p, w, a, lr, rho)
    assert kern.launches["adafbio_update"] == before + 1
    _close(got, ref.adafbio_update_ref(p, w, a, lr, rho))
    loop = torch.cat([kern.adafbio_update(p[i:i + 1].contiguous(),
                                          w[i:i + 1].contiguous(),
                                          a[i].contiguous(), lr, rho)
                      for i in range(m)])
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), loop.view(torch.int32))


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
        kern.adafbio_update(x, x, x[:, :4].contiguous(), beta, beta)
    with pytest.raises(ValueError, match="shape"):
        kern.adafbio_update(x, x, torch.ones(3, 8, device=cuda), beta, beta)


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


def _leaves(g, m, specs, offset, device):
    """Leaves of ``m`` rows, ``specs`` (elements a row, dtype), each a view
    ``offset`` elements into its allocation."""
    out = []
    for n, dt in specs:
        flat = torch.randn(m * n + offset, generator=g, device=device)
        out.append(flat.to(dt)[offset:].view(m, n))
    return out


MIXED = [(4096, torch.bfloat16), (1000, torch.float32), (1, torch.bfloat16),
         (2, torch.float32), (3, torch.bfloat16), (777, torch.bfloat16)]


@pytest.mark.parametrize("m,offset", [(1, 0), (3, 0), (2, 1)])
@pytest.mark.parametrize("per_row", [False, True])
def test_leaf_table_entries_equal_packed_and_plain(cuda, m, offset, per_row):
    """The leaf-table entries on mixed f32/bf16 leaves, where they lie: one
    launch each, bit for bit the packed f32 entry (pack, kernel, cast back)
    and the per-leaf plain version."""
    from repro_torch.core.tree_util import (tree_pack_stacked,
                                            tree_unpack_stacked)
    g = torch.Generator(device=cuda)
    g.manual_seed(m * 10 + offset)
    gn, go, est, p, w = (_leaves(g, m, MIXED, offset, cuda)
                         for _ in range(5))
    if per_row:
        a = [t.abs_() for t in _leaves(g, m, MIXED, offset, cuda)]
    else:
        a = [t[0].abs_() for t in _leaves(g, 1, MIXED, offset, cuda)]
    beta = torch.full((), 0.3, device=cuda)
    lr, rho = torch.full((), 0.01, device=cuda), torch.full((), 1e-4,
                                                            device=cuda)
    before = dict(kern.launches)
    got_s = kern.storm_update_leaves(gn, go, est, beta)
    got_a = kern.adafbio_update_leaves(p, w, a, lr, rho)
    assert kern.launches["storm_update"] == before["storm_update"] + 1
    assert kern.launches["adafbio_update"] == before["adafbio_update"] + 1
    fl_e, spec = tree_pack_stacked(est)
    packed_s = tree_unpack_stacked(kern.storm_update(
        tree_pack_stacked(gn, spec)[0], tree_pack_stacked(go, spec)[0],
        fl_e, beta), spec)
    fl_p, spec = tree_pack_stacked(p)
    fl_a = (tree_pack_stacked(a, spec)[0] if per_row else
            tree_pack_stacked([t.unsqueeze(0) for t in a])[0][0])
    packed_a = tree_unpack_stacked(kern.adafbio_update(
        fl_p, tree_pack_stacked(w, spec)[0], fl_a, lr, rho), spec)
    plain_s = [ref.storm_update_ref(*t, beta) for t in zip(gn, go, est)]
    plain_a = [ref.adafbio_update_ref(*t, lr, rho) for t in zip(p, w, a)]
    torch.cuda.synchronize()
    for got, packed, plain in ((got_s, packed_s, plain_s),
                               (got_a, packed_a, plain_a)):
        for x, y, z in zip(got, packed, plain):
            assert x.dtype == y.dtype == z.dtype
            assert torch.equal(_bits(x), _bits(y))
            _close(x.float(), z.float())


def test_leaf_table_wrappers_reject_what_the_kernel_does_not_take(cuda):
    x = torch.ones(2, 8, device=cuda)
    beta = torch.full((), 0.5, device=cuda)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        kern.storm_update_leaves([x.double()], [x], [x], beta)
    with pytest.raises(ValueError, match="contiguous"):
        kern.storm_update_leaves([x.t().contiguous().t()], [x], [x], beta)
    with pytest.raises(ValueError, match="shape"):
        kern.storm_update_leaves([x[:, :4].contiguous()], [x], [x], beta)
    with pytest.raises(ValueError, match="shape"):
        kern.adafbio_update_leaves([x], [x], [torch.ones(3, device=cuda)],
                                   beta, beta)
    with pytest.raises(TypeError, match="one-element"):
        kern.storm_update_leaves([x], [x], [x], 0.5)


def test_tree_wrappers_make_one_launch_over_all_leaves(cuda):
    from repro_torch.kernels import ops
    tree = {"a": torch.ones(3, 5, device=cuda, dtype=torch.bfloat16),
            "b": [torch.ones(3, 7, device=cuda), torch.ones(3, 1, 1,
                                                             device=cuda)]}
    acc = {"a": torch.ones(5, device=cuda, dtype=torch.bfloat16),
           "b": [torch.ones(7, device=cuda), torch.ones(1, 1, device=cuda)]}
    kern.reset_launches()
    out = ops.storm_update_tree(tree, tree, tree, 0.5)
    out2 = ops.adafbio_update_tree(tree, tree, acc, 0.1, 1e-4)
    assert kern.launches == {"storm_update": 1, "adafbio_update": 1}
    assert out["a"].dtype == torch.bfloat16 and out2["b"][1].shape == (3, 1,
                                                                       1)


def _bits(t):
    """The tensor's raw bits, so that equality is bit for bit."""
    return t.view(torch.int32) if t.dtype == torch.float32 else t


@pytest.mark.parametrize("m,sizes,offset,bits", [
    (8, (4096, 1000, 20, 3), 0, 8), (1, (1001,), 0, 4), (3, (1, 2), 0, 8),
    (2, (5, 770), 1, 2), (2, (500, 504), 1, 8), (4, (64, 0, 64), 0, 8)])
def test_quantize_kernels_equal_plain_versions(cuda, m, sizes, offset, bits):
    """Levels and dequantized values equal the plain versions bit for bit,
    at ragged lengths, misaligned views (one with n % 4 == 0, where only the
    alignment test keeps the vector path off) and an empty segment."""
    g = torch.Generator(device=cuda)
    g.manual_seed(sum(sizes) + bits)
    n = sum(sizes)
    flat = torch.randn(m * n + offset, generator=g, device=cuda) * 3.0
    x = flat[offset:].view(m, n)
    u = torch.rand((m, n), generator=g, device=cuda)
    offsets = [0]
    for s in sizes:
        offsets.append(offsets[-1] + s)
    qmax = (1 << (bits - 1)) - 1
    scale = torch.rand((m, len(sizes)), generator=g, device=cuda) + 0.01
    table = torch.tensor(offsets, device=cuda)
    before = dict(qkern.launches)
    q = qkern.quantize_stoch(x, u, scale, table, qmax)
    q_in = q
    if offset:
        # the levels as a view misaligned by the same offset
        qbuf = torch.empty(m * n + offset, dtype=torch.int8, device=cuda)
        qbuf[offset:].copy_(q.view(-1))
        q_in = qbuf[offset:].view(m, n)
    back = qkern.dequantize(q_in, scale, table)
    torch.cuda.synchronize()
    assert torch.equal(q, ref.quantize_stoch_ref(x, u, scale, table, qmax))
    assert torch.equal(_bits(back), _bits(ref.dequantize_ref(q, scale,
                                                             table)))
    assert qkern.launches["quantize_stoch"] == before["quantize_stoch"] + 1
    assert qkern.launches["dequantize"] == before["dequantize"] + 1


def test_quantize_wrappers_reject_what_the_kernel_does_not_take(cuda):
    x = torch.ones(2, 8, device=cuda)
    table = torch.tensor([0, 3, 8], device=cuda)
    scale = torch.ones(2, 2, device=cuda)
    with pytest.raises(TypeError, match="float32"):
        qkern.quantize_stoch(x.double(), x, scale, table, 127)
    with pytest.raises(TypeError, match="int64"):
        qkern.quantize_stoch(x, x, scale, table.int(), 127)
    with pytest.raises(ValueError, match="shape"):
        qkern.quantize_stoch(x, x, scale[:, :1], table, 127)
    with pytest.raises(ValueError, match="qmax"):
        qkern.quantize_stoch(x, x, scale, table, 300)
    with pytest.raises(TypeError, match="int8"):
        qkern.dequantize(x, scale, table)


def test_int8_codec_makes_one_launch_each_per_message(cuda):
    from repro_torch.fed import compress
    m = 5
    ref_t = {"a": torch.randn(m, 7, 3, device=cuda),
             "b": {"c": torch.randn(m, 11, device=cuda),
                   "d": torch.randn(m, 1, device=cuda)}}
    cur = {"a": ref_t["a"] + 0.1, "b": {"c": ref_t["b"]["c"] * 1.5,
                                        "d": ref_t["b"]["d"] - 2.0}}
    codec = compress.make_codec("int8")
    ef = compress.zeros_ef(codec, ref_t)
    # the message goes leaf by leaf: one quantize and one dequantize
    # launch over the m rows of each of its 3 leaves
    u = compress.CodecNoise(0, cuda)(0, torch.arange(m, device=cuda))
    qkern.reset_launches()
    recon, ef2 = compress.client_messages(codec, ref_t, cur, ef, u)
    assert qkern.launches == {"quantize_stoch": 3, "dequantize": 3}
    def cpu(t):
        return tree_map(lambda a: a.cpu(), t)
    want = compress.client_messages(codec, cpu(ref_t), cpu(cur), cpu(ef),
                                    lambda i, size: u(i, size).cpu())
    for got_t, want_t in zip((recon, ef2), want):
        for a, b in zip(tree_leaves(got_t), tree_leaves(want_t)):
            torch.testing.assert_close(a.cpu(), b, rtol=1e-6, atol=1e-6)


# ------------------------------------------------------------ serve kernels

def _attn_tol(dtype):
    """1e-6 in f32 (sums run in another order than the plain version's),
    2e-2 in bf16 (the output's rounding), the reference's kernel
    tolerances."""
    return 2e-2 if dtype == torch.bfloat16 else 1e-6


def _attn_close(got, want, dtype):
    """Element by element, as the reference's kernel tests hold theirs
    (tests/test_kernels.py:45): |got - want| <= tol + tol * |want|."""
    torch.cuda.synchronize()
    tol = _attn_tol(dtype)
    torch.testing.assert_close(got.float(), want.float(), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("b,h,kv,s,d,causal,window,dtype,strided", [
    (1, 8, 2, 256, 128, True, None, torch.bfloat16, True),    # GQA
    (1, 4, 4, 200, 64, True, None, torch.float32, True),      # MHA, ragged
    (1, 32, 32, 300, 64, True, None, torch.bfloat16, True),   # hybrid's block
    (1, 32, 4, 300, 64, True, None, torch.bfloat16, True),    # qwen3-moe
    (1, 64, 8, 260, 128, True, None, torch.bfloat16, True),   # 64 over 8
    (2, 8, 1, 130, 128, True, None, torch.bfloat16, False),   # MQA
    (1, 4, 2, 512, 64, True, 128, torch.float32, True),       # window
    (1, 4, 2, 100, 64, False, None, torch.float32, False),    # not causal
    (1, 4, 2, 77, 128, False, 30, torch.bfloat16, True),      # window only
    # the tensor-core kernel's edges (bf16; BQ = BK = 128)
    (1, 8, 2, 1000, 128, True, None, torch.bfloat16, True),   # ragged S
    (1, 4, 2, 77, 64, True, None, torch.bfloat16, False),     # S < one tile
    (2, 4, 4, 40, 128, True, None, torch.bfloat16, True),     # S < 64
    (1, 8, 2, 300, 128, True, 30, torch.bfloat16, True),      # narrow window
    (1, 40, 8, 384, 128, True, None, torch.bfloat16, True),   # GQA 40/8
    (2, 32, 32, 520, 64, True, None, torch.bfloat16, False),  # Dh 64, 32/32
])
def test_flash_attention_matches_plain_version(cuda, b, h, kv, s, d, causal,
                                               window, dtype, strided):
    """At the prefill's [B, S, H, D] layout viewed as [B, H, S, D]
    (``strided``) and at contiguous [B, H, S, D]."""
    from repro_torch.kernels import flash_attention as fkern
    g = torch.Generator(device=cuda)
    g.manual_seed(s * h + d)

    def make(heads):
        if strided:
            return torch.randn(b, s, heads, d, generator=g, device=cuda,
                               dtype=dtype).transpose(1, 2)
        return torch.randn(b, heads, s, d, generator=g, device=cuda,
                           dtype=dtype)
    q, k, v = make(h), make(kv), make(kv)
    before = fkern.launches["flash_attention"]
    got = fkern.flash_attention(q, k, v, causal=causal, window=window)
    assert fkern.launches["flash_attention"] == before + 1
    assert got.dtype == dtype and got.stride() == q.stride()
    _attn_close(got, ref.flash_attention_ref(q, k, v, causal=causal,
                                             window=window), dtype)


@pytest.mark.parametrize("b,h,kv,sq,sk,d,strided", [
    (1, 6, 6, 77, 300, 64, True),        # a prompt over fewer frames
    (1, 6, 6, 224, 2048, 64, True),      # whisper's cross-attention
    (1, 6, 6, 77, 1500, 64, True),       # whisper's 1500 frames (ragged)
    (2, 6, 6, 2048, 2048, 64, False),    # whisper's encoder
    (1, 8, 2, 130, 40, 128, True),       # more queries than keys, GQA
])
def test_flash_attention_not_causal_at_sq_not_sk(cuda, b, h, kv, sq, sk, d,
                                                 strided):
    """The encdec prefill's attentions in bf16 on the tensor-core kernel:
    not causal, the queries' length other than the keys' (the
    cross-attention: the prompt over the encoder's frames; the encoder
    itself at Sq = Sk), in the prefill's [B, S, H, D] layout viewed as
    [B, H, S, D] (``strided``) or contiguous."""
    from repro_torch.kernels import flash_attention as fkern
    g = torch.Generator(device=cuda)
    g.manual_seed(sq * 7 + sk)

    def make(heads, s):
        if strided:
            return torch.randn(b, s, heads, d, generator=g, device=cuda,
                               dtype=torch.bfloat16).transpose(1, 2)
        return torch.randn(b, heads, s, d, generator=g, device=cuda,
                           dtype=torch.bfloat16)
    q, k, v = make(h, sq), make(kv, sk), make(kv, sk)
    before = fkern.launches["flash_attention"]
    got = fkern.flash_attention(q, k, v, causal=False)
    assert fkern.launches["flash_attention"] == before + 1
    assert got.shape == q.shape and got.stride() == q.stride()
    _attn_close(got, ref.flash_attention_ref(q, k, v, causal=False),
                torch.bfloat16)


@pytest.mark.parametrize("b,h,kv,w,d,pos,dtype,offset", [
    (3, 8, 2, 200, 128, (1, 200, 77), torch.bfloat16, 0),   # [B] pos, ragged W
    (2, 12, 1, 64, 128, (64, 5), torch.bfloat16, 0),        # MQA
    (3, 32, 4, 200, 64, (1, 200, 77), torch.bfloat16, 0),   # qwen3-moe
    (2, 64, 8, 130, 128, (130, 9), torch.bfloat16, 0),      # 64 over 8
    (2, 4, 4, 150, 64, 150, torch.float32, 0),              # scalar pos
    (2, 8, 2, 100, 64, (3, 99), torch.float32, 1),          # misaligned
    (1, 4, 2, 70, 64, 0, torch.float32, 0),                 # nothing valid
    (3, 8, 2, 200, 128, (200, 193, 199), torch.bfloat16, 0),  # every run
    # shares that cross from one row into the next
    (8, 40, 8, 2048, 128, (2048,) + (1,) * 7, torch.bfloat16, 0),
    (8, 40, 8, 2048, 128, (2048,) + (1,) * 7, torch.float32, 0),
    (8, 40, 8, 512, 128, (0,) * 8, torch.float32, 0),       # all rows at 0
    (8, 40, 8, 2048, 128, (2048,) * 8, torch.bfloat16, 0),  # pos = W
    (4, 32, 4, 1000, 64, (1000, 3, 640, 999), torch.float32, 0),  # g 8
    (4, 32, 4, 1000, 64, (1000, 3, 640, 999), torch.bfloat16, 0),
    # whisper-tiny's decoder: 6 heads over 6 (a group of 1) at Dh 64
    (8, 6, 6, 2048, 64, (1, 2048, 1000, 1536, 37, 2047, 512, 1300),
     torch.bfloat16, 0),
    (3, 6, 6, 448, 64, (4, 448, 229), torch.float32, 0),
])
def test_quant_decode_matches_plain_version(cuda, b, h, kv, w, d, pos, dtype,
                                            offset):
    """Through one layer's [B, W, KV, Dh] pool slice viewed as
    [B, KV, W, Dh] (the serve path's layout; ``offset`` shifts the levels
    off 16-byte alignment), at per-row and scalar positions; "every run":
    each row reaches into the last tiles of the cache; the cases below it
    give the blocks shares that cross from one (row, kv head) into the
    next, so a pair is merged from several blocks' partials."""
    from repro_torch.kernels import quant_decode as qd
    g = torch.Generator(device=cuda)
    g.manual_seed(w * h + d)
    q = torch.randn(b, h, d, generator=g, device=cuda, dtype=dtype)

    def pool():
        x = torch.randn(b, w, kv, d, generator=g, device=cuda)
        lv, sc = qd.quantize_kv(x)
        buf = torch.empty(lv.numel() + offset, dtype=torch.int8, device=cuda)
        buf[offset:].copy_(lv.view(-1))
        return buf[offset:].view(b, w, kv, d).transpose(1, 2), sc.transpose(
            1, 2)
    (k8, ks), (v8, vs) = pool(), pool()
    p = (torch.tensor(pos, dtype=torch.int32, device=cuda)
         if isinstance(pos, tuple) else pos)
    before = qd.launches["quant_decode_attention"]
    got = qd.quant_decode_attention(q, k8, ks, v8, vs, p)
    assert qd.launches["quant_decode_attention"] == before + 1
    assert got.dtype == dtype
    _attn_close(got, ref.quant_decode_ref(q, k8, ks, v8, vs, p), dtype)


def test_serve_wrappers_reject_what_the_kernels_do_not_take(cuda):
    from repro_torch.kernels import flash_attention as fkern
    from repro_torch.kernels import quant_decode as qd
    x = torch.zeros(1, 4, 8, 64, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        fkern.flash_attention(x[..., :48], x[..., :48], x[..., :48])
    with pytest.raises(TypeError, match="dtype"):
        fkern.flash_attention(x.half(), x.half(), x.half())
    with pytest.raises(TypeError, match="dtype"):
        fkern.flash_attention(x, x.bfloat16(), x)
    with pytest.raises(ValueError, match="split evenly"):
        fkern.flash_attention(x, x[:, :3], x[:, :3])
    with pytest.raises(ValueError, match="contiguous last"):
        t = torch.zeros(1, 4, 64, 8, device=cuda).transpose(2, 3)
        fkern.flash_attention(t, t, t)
    # a bf16 row stride of 68 elements (136 bytes) is no multiple of 16
    # bytes, which the tensor-core kernel's TMA loads need
    before = fkern.launches["flash_attention"]
    with pytest.raises(ValueError, match="TMA"):
        t = torch.zeros(1, 4, 8, 68, dtype=torch.bfloat16,
                        device=cuda)[..., :64]
        fkern.flash_attention(t, t, t)
    assert fkern.launches["flash_attention"] == before
    q = torch.zeros(2, 4, 64, device=cuda)
    k8 = torch.zeros(2, 2, 16, 64, dtype=torch.int8, device=cuda)
    sc = torch.ones(2, 2, 16, device=cuda)
    with pytest.raises(TypeError, match="int8"):
        qd.quant_decode_attention(q, k8.float(), sc, k8, sc, 3)
    with pytest.raises(ValueError, match="scales"):
        qd.quant_decode_attention(q, k8, sc[:, :, :8], k8, sc, 3)
    with pytest.raises(ValueError, match="pos"):
        qd.quant_decode_attention(q, k8, sc, k8, sc,
                                  torch.ones(3, dtype=torch.int32,
                                             device=cuda))
    # each row's position and first task sit in shared memory: 25,000 rows
    # overflow a block (any group size fits: large groups take passes)
    rows = torch.zeros(25_000, 2, 64, device=cuda)
    k1 = torch.zeros(25_000, 2, 1, 64, dtype=torch.int8, device=cuda)
    s1 = torch.ones(25_000, 2, 1, device=cuda)
    with pytest.raises(ValueError, match="shared memory"):
        qd.quant_decode_attention(rows, k1, s1, k1, s1, 3)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_quant_decode_replays_in_a_cuda_graph(cuda, dtype):
    """The call captured in a CUDA graph with q and pos in static tensors:
    each replay, after both change, equals an eager call bit for bit (the
    merge counters come back to zero, and no host sync reads pos)."""
    from repro_torch.kernels import quant_decode as qd
    g = torch.Generator(device=cuda)
    g.manual_seed(11)
    b, h, kv, w, d = 8, 40, 8, 2048, 128
    pool = [qd.quantize_kv(torch.randn(b, w, kv, d, generator=g,
                                       device=cuda)) for _ in range(2)]
    (k8, ks), (v8, vs) = [(lv.transpose(1, 2), sc.transpose(1, 2))
                          for lv, sc in pool]
    rows = [(1, 2048, 1000, 1536, 37, 2047, 512, 1300),
            (2048,) + (1,) * 7, (0,) * 8, (64, 65, 63, 3000, 128, 1, 2, 777)]
    qs = [torch.randn(b, h, d, generator=g, device=cuda, dtype=dtype)
          for _ in rows]
    q_in = qs[0].clone()
    p_in = torch.tensor(rows[0], dtype=torch.int32, device=cuda)
    side = torch.cuda.Stream(cuda)
    side.wait_stream(torch.cuda.current_stream(cuda))
    with torch.cuda.stream(side):              # warm up: build, allocate
        qd.quant_decode_attention(q_in, k8, ks, v8, vs, p_in)
    torch.cuda.current_stream(cuda).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = qd.quant_decode_attention(q_in, k8, ks, v8, vs, p_in)
    for q, pos in zip(qs, rows):
        q_in.copy_(q)
        p_in.copy_(torch.tensor(pos, dtype=torch.int32))
        graph.replay()
        eager = qd.quant_decode_attention(q, k8, ks, v8, vs, p_in)
        torch.cuda.synchronize()
        assert torch.equal(out, eager)
        _attn_close(eager, ref.quant_decode_ref(q, k8, ks, v8, vs, p_in),
                    dtype)


def test_engine_on_the_card_launches_both_kernels(cuda):
    """A reduced model served on the card: one flash launch per layer per
    admission, one int8-decode launch per layer per tick, and the same
    tokens as the reference's dequant path ("xla", f32 weights)."""
    from repro_torch import device as devlib
    from repro_torch.configs import get_arch, reduced
    from repro_torch.kernels import flash_attention as fkern
    from repro_torch.kernels import quant_decode as qd
    from repro_torch.models import init_params, model_specs
    from repro_torch.serve import Engine, LoadSpec, generate_requests
    cfg = reduced(get_arch("qwen2.5-14b"), dtype="float32", n_kv_heads=2)
    params = init_params(model_specs(cfg), devlib.generator(cuda, 0),
                         "float32")
    reqs = generate_requests(LoadSpec(n_requests=5, prompt_lens=(4, 70),
                                      mean_new_tokens=4.0, max_new_cap=6,
                                      seed=3), cfg.vocab)
    fkern.reset_launches()
    qd.reset_launches()
    eng = Engine(cfg, params, slots=3, max_len=96, kv_quant=True)
    got = {c.rid: c.tokens for c in eng.run(reqs)}
    assert fkern.launches["flash_attention"] == cfg.n_layers * len(reqs)
    assert (qd.launches["quant_decode_attention"]
            == cfg.n_layers * len(eng.timings["decode"]))
    want = Engine(cfg, params, slots=3, max_len=96, kv_quant=True,
                  kv_kernel="xla").run(reqs)
    assert got == {c.rid: c.tokens for c in want}


def _scan_inputs(g, cuda, b, s, di, n, dtype, strided):
    """Inputs of the mamba1 scan as the model makes them: dt a softplus, A
    = -(1..N) per channel, B and C column slices of a [B, S, dtr + 2N]
    projection (``strided``) or contiguous."""
    def rand(*shape):
        return torch.randn(*shape, generator=g, device=cuda)
    x = rand(b, s, di).to(dtype)
    dt = torch.nn.functional.softplus(rand(b, s, di) - 1.0).to(dtype)
    A = -torch.arange(1, n + 1, device=cuda, dtype=torch.float32).expand(
        di, n).contiguous()
    if strided:
        proj = rand(b, s, 16 + 2 * n).to(dtype)
        return x, dt, A, proj[..., 16:16 + n], proj[..., 16 + n:]
    return x, dt, A, rand(b, s, n).to(dtype), rand(b, s, n).to(dtype)


@pytest.mark.parametrize("b,s,di,n,dtype,strided", [
    (1, 300, 1024, 16, torch.float32, True),   # B and C as column slices
    (2, 64, 1004, 16, torch.float32, False),   # ragged Di (1004 % 16)
    (1, 1, 256, 16, torch.float32, True),      # S 1
    (2, 130, 512, 16, torch.bfloat16, True),   # bf16, ragged tile of steps
    (1, 70, 256, 8, torch.float32, False),     # N 8: lanes past N
    (1, 65, 96, 12, torch.float32, True),      # N 12: a lane past N
    (1, 65, 512, 16, torch.float32, True),     # S one tile + 1
    (1, 129, 256, 16, torch.bfloat16, True),   # two tiles + 1, bf16
    (2, 65, 1004, 16, torch.bfloat16, False),  # bf16 rows not in 16 bytes
    (1, 70, 96, 10, torch.float32, True),      # N 10: a lane half past N
    (1, 70, 100, 5, torch.bfloat16, False),    # rows not in 16 bytes
])
def test_mamba_scan_matches_plain_version(cuda, b, s, di, n, dtype, strided):
    """y and the f32 last state, each element within tol (1 + |plain|):
    1e-5 in f32 (the reference's own, tests/test_kernels.py:236), 2e-2 in
    bf16 (y's rounding)."""
    from repro_torch.kernels import mamba_scan as mk
    g = torch.Generator(device=cuda)
    g.manual_seed(s * di + n)
    args = _scan_inputs(g, cuda, b, s, di, n, dtype, strided)
    before = mk.launches["mamba_scan"]
    y, h = mk.mamba_scan(*args)
    assert mk.launches["mamba_scan"] == before + 1
    y_ref, h_ref = ref.mamba_scan_ref(*args)
    torch.cuda.synchronize()
    assert y.dtype == dtype and h.dtype == torch.float32
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    for got, want in ((y, y_ref), (h, h_ref)):
        assert got.shape == want.shape
        assert ((got.float() - want.float()).abs()
                <= tol * (1 + want.float().abs())).all()


def test_mamba_scan_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    from repro_torch.kernels import mamba_scan as mk
    x = torch.zeros(1, 4, 32, device=cuda)
    A = torch.zeros(32, 16, device=cuda)
    bc = torch.zeros(1, 4, 16, device=cuda)
    with pytest.raises(ValueError, match="dt must have shape"):
        mk.mamba_scan(x, x[:, :3], A, bc, bc)
    with pytest.raises(TypeError, match="x must be"):
        mk.mamba_scan(x.half(), x, A, bc, bc)
    with pytest.raises(ValueError, match="state dimension"):
        big = torch.zeros(1, 4, 17, device=cuda)
        mk.mamba_scan(x, x, torch.zeros(32, 17, device=cuda), big, big)
    with pytest.raises(ValueError, match="empty scan"):
        mk.mamba_scan(x[:, :0], x[:, :0], A, bc[:, :0], bc[:, :0])


@pytest.mark.parametrize("arch_id", ["falcon-mamba-7b", "zamba2-1.2b"])
def test_engine_on_the_card_serves_ssm_and_hybrid(cuda, arch_id):
    """A reduced model served on the card: falcon-mamba-7b's prefill
    launches mamba_scan once a layer, zamba2's shared block flash_attention
    once a segment, and the tokens equal the reference paths' ("xla", f32
    weights)."""
    from repro_torch import device as devlib
    from repro_torch.configs import get_arch, reduced
    from repro_torch.kernels import flash_attention as fkern
    from repro_torch.kernels import mamba_scan as mk
    from repro_torch.models import init_params, model_specs
    from repro_torch.serve import Engine, LoadSpec, generate_requests
    kw = {"n_layers": 5} if arch_id == "zamba2-1.2b" else {}
    cfg = reduced(get_arch(arch_id), dtype="float32", **kw)
    params = init_params(model_specs(cfg), devlib.generator(cuda, 0),
                         "float32")
    reqs = generate_requests(LoadSpec(n_requests=5, prompt_lens=(4, 70),
                                      mean_new_tokens=4.0, max_new_cap=6,
                                      seed=3), cfg.vocab)
    fkern.reset_launches()
    mk.reset_launches()
    got = {c.rid: c.tokens for c in Engine(cfg, params, slots=3,
                                           max_len=96).run(reqs)}
    if arch_id == "falcon-mamba-7b":
        assert mk.launches["mamba_scan"] == cfg.n_layers * len(reqs)
        assert fkern.launches["flash_attention"] == 0
    else:
        nseg = cfg.n_layers // cfg.shared_attn_every
        assert fkern.launches["flash_attention"] == nseg * len(reqs)
        assert mk.launches["mamba_scan"] == 0
    want = Engine(cfg, params, slots=3, max_len=96, kv_kernel="xla").run(
        reqs)
    assert got == {c.rid: c.tokens for c in want}


def test_engine_on_the_card_serves_encdec(cuda):
    """Reduced whisper-tiny (f32) served on the card with the int8 pool:
    flash_attention once a layer of the encoder and twice a decoder layer
    (self- and cross-attention) an admission, the int8 decode once a
    decoder layer a tick; the same tokens as the engine on the CPU (the
    kernels' plain versions), and the pool's cross cache equal to the
    CPU's within the attention tolerance after the first admission and
    tick."""
    from repro_torch import device as devlib
    from repro_torch.configs import get_arch, reduced
    from repro_torch.core.tree_util import tree_map
    from repro_torch.kernels import flash_attention as fkern
    from repro_torch.kernels import quant_decode as qd
    from repro_torch.models import init_params, model_specs
    from repro_torch.serve import Engine, LoadSpec, generate_requests
    cfg = reduced(get_arch("whisper-tiny"), dtype="float32")
    params = init_params(model_specs(cfg), devlib.generator("cpu", 0),
                         "float32")
    reqs = generate_requests(LoadSpec(n_requests=5, prompt_lens=(4, 30),
                                      mean_new_tokens=4.0, max_new_cap=6,
                                      seed=3), cfg.vocab,
                             enc_shape=(96, cfg.d_model))
    engines = {dev: Engine(cfg, tree_map(lambda t: t.to(dev), params),
                           slots=3, max_len=96, kv_quant=True, device=dev)
               for dev in ("cpu", "cuda")}
    fkern.reset_launches()
    qd.reset_launches()
    for eng in engines.values():
        eng.submit(reqs[0])
        eng.step()
    pool = {d: e._pool for d, e in engines.items()}
    for key in ("ck", "cv"):
        _attn_close(pool["cuda"][key].float().cpu(),
                    pool["cpu"][key].float(), torch.bfloat16)
    got = {d: {c.rid: c.tokens for c in e.run(reqs[1:])}
           for d, e in engines.items()}
    assert got["cuda"] == got["cpu"]
    card = engines["cuda"]
    assert (fkern.launches["flash_attention"]
            == (cfg.encoder.n_layers + 2 * cfg.n_layers) * len(reqs))
    assert (qd.launches["quant_decode_attention"]
            == cfg.n_layers * len(card.timings["decode"]))
