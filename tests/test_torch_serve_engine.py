"""The port's serve engine: the continuous-batching scheduler changes
throughput, never results (the properties ``tests/test_serve_engine.py``
pins on the JAX engine, held on the port's, on the CPU).

- engine output == an independent B=1 greedy loop over the same
  ``build_serve_fns`` callables;
- engine output == the same engine serving one request at a time, with the
  full-precision pool and with the int8 pool;
- EOS truncates and frees the slot; a prompt near ``max_len`` retires at
  capacity; ``submit`` and the constructor reject what they must, the
  JAX package's kernel names included;
- slot-lifecycle invariants (also under hypothesis): slots never
  double-book, every request completes once with a consistent reason.
"""
import numpy as np
import pytest
import torch

from repro_torch import device as devlib
from repro_torch.configs import ShapeConfig, get_arch, reduced
from repro_torch.fed.serve import build_serve_fns
from repro_torch.models import init_params, model_specs
from repro_torch.models.decode import zeros
from repro_torch.serve import Engine, LoadSpec, Request, generate_requests

torch.set_num_threads(1)
CPU = torch.device("cpu")
MAX_LEN = 24
_MEMO = {}


def _model(arch_id="qwen1.5-4b"):
    if arch_id not in _MEMO:
        cfg = reduced(get_arch(arch_id), dtype="float32")
        params = init_params(model_specs(cfg), devlib.generator(CPU, 0),
                             "float32")
        _MEMO[arch_id] = (cfg, params)
    return _MEMO[arch_id]


def _workload(cfg, n=5, seed=3, max_new=6):
    spec = LoadSpec(n_requests=n, prompt_lens=(4, 7), mean_new_tokens=4.0,
                    max_new_cap=max_new, seed=seed)
    return generate_requests(spec, cfg.vocab)


def _engine(cfg, params, **kw):
    kw.setdefault("max_len", MAX_LEN)
    return Engine(cfg, params, device="cpu", **kw)


def _tokens(completions):
    return {c.rid: c.tokens for c in completions}


def _sequential(cfg, params, reqs, max_len):
    """Independent B=1 greedy loop straight over build_serve_fns: no
    engine, no slot pool, scalar pos. rid -> generated tokens."""
    pre = build_serve_fns(cfg, ShapeConfig("p", max_len, 1, "prefill"))
    dec = build_serve_fns(cfg, ShapeConfig("d", max_len, 1, "decode"))
    out = {}
    for req in reqs:
        cache = zeros(pre["cache_abs"], CPU)
        logits, cache = pre["prefill"](
            params, {"tokens": torch.from_numpy(req.tokens[None])}, cache)
        toks = [int(logits[0, 0].argmax())]
        pos, budget = len(req.tokens), req.max_new_tokens - 1
        while budget > 0 and pos < max_len:
            logits, cache = dec["decode"](
                params, cache, torch.tensor([[toks[-1]]]),
                torch.tensor(pos, dtype=torch.int32))
            toks.append(int(logits[0, 0].argmax()))
            pos += 1
            budget -= 1
        out[req.rid] = toks
    return out


@pytest.mark.parametrize("arch_id", ["qwen1.5-4b", "granite-20b"])
def test_engine_matches_sequential(arch_id):
    cfg, params = _model(arch_id)
    reqs = _workload(cfg)
    got = _tokens(_engine(cfg, params, slots=3).run(reqs))
    assert got == _sequential(cfg, params, reqs, MAX_LEN)


@pytest.mark.parametrize("kv_quant", [False, True])
def test_engine_one_at_a_time_identity(kv_quant):
    cfg, params = _model()
    reqs = _workload(cfg, n=6)
    got = _tokens(_engine(cfg, params, slots=4, kv_quant=kv_quant).run(reqs))
    solo = _engine(cfg, params, slots=4, kv_quant=kv_quant)
    want = {}
    for r in reqs:
        want.update(_tokens(solo.run([r])))
    assert got == want


def test_engine_times_every_admission_and_tick():
    cfg, params = _model()
    reqs = _workload(cfg, n=4)
    eng = _engine(cfg, params, slots=2, kv_quant=True)
    done = eng.run(reqs)
    assert len(done) == len(eng.timings["prefill"]) == len(reqs)
    # every tick of a drain has an active slot, so each ran one decode
    assert len(eng.timings["decode"]) == eng._ticks > 0
    assert all(t > 0 for ts in eng.timings.values() for t in ts)


def test_eos_truncates_and_frees_slot():
    cfg, params = _model()
    reqs = _workload(cfg, n=5)
    base = _tokens(_engine(cfg, params, slots=2).run(reqs))
    rid, toks = next((r, t) for r, t in sorted(base.items()) if len(t) >= 3)
    eos = toks[1]
    done = _engine(cfg, params, slots=2, eos_id=eos).run(reqs)
    got = _tokens(done)
    assert got[rid] == base[rid][:base[rid].index(eos) + 1]
    assert next(c for c in done if c.rid == rid).finish_reason == "eos"
    for r, t in base.items():
        if r != rid and eos not in t:
            assert got[r] == t


def test_capacity_retirement():
    cfg, params = _model()
    req = Request(rid=0, tokens=np.arange(10, dtype=np.int32) % cfg.vocab,
                  max_new_tokens=30)
    done = _engine(cfg, params, slots=1, max_len=12).run([req])
    assert done[0].finish_reason == "capacity"
    # pos walks plen .. max_len: the first token from prefill, one per tick
    assert len(done[0].tokens) == 12 - 10 + 1


def test_submit_and_constructor_reject_bad_input():
    cfg, params = _model()
    eng = _engine(cfg, params, slots=1, max_len=12)
    with pytest.raises(ValueError, match="empty prompt"):
        eng.submit(Request(rid=0, tokens=np.zeros(0, np.int32)))
    with pytest.raises(ValueError, match="max_new_tokens"):
        eng.submit(Request(rid=1, tokens=np.zeros(4, np.int32),
                           max_new_tokens=0))
    with pytest.raises(ValueError, match="prompt_len"):
        eng.submit(Request(rid=2, tokens=np.zeros(12, np.int32)))
    with pytest.raises(ValueError, match="slots"):
        _engine(cfg, params, slots=0)
    with pytest.raises(ValueError, match="kv_kernel must be one of"):
        _engine(cfg, params, slots=1, kv_kernel="cuda")
    for tpu in ("pallas", "interpret"):
        with pytest.raises(ValueError, match="the port's choices are"):
            _engine(cfg, params, slots=1, kv_kernel=tpu)
    with pytest.raises(ValueError, match="runs the CUDA kernel"):
        _engine(cfg, params, slots=1, kv_quant=True, kv_kernel="kernel")
    with pytest.raises(ValueError, match="params must be on"):
        _engine(cfg, {"x": {"w": torch.zeros(1, device="meta")}}, slots=1)


# -------------------------------------------------- lifecycle invariants

def _check_lifecycle(slots, n, max_new, seed):
    """The slot ledger stays consistent every tick (free + occupied ==
    slots, no rid in two slots), every submitted request completes exactly
    once, and each completion's token count and finish reason agree."""
    cfg, params = _model()
    reqs = _workload(cfg, n=n, seed=seed, max_new=max_new)
    eng = _engine(cfg, params, slots=slots, max_len=16)
    for r in reqs:
        eng.submit(r)
    done = []
    while eng.has_work:
        done.extend(eng.step())
        occupied = [o.rid for o in eng._occupant if o is not None]
        assert len(eng._free) + len(occupied) == slots
        assert len(occupied) == len(set(occupied))
        assert eng.active <= slots
    got = {c.rid: c for c in done}
    assert sorted(got) == [r.rid for r in reqs]
    for r in reqs:
        c = got[r.rid]
        assert 1 <= len(c.tokens) <= r.max_new_tokens
        plen = len(r.tokens)
        assert plen + len(c.tokens) - 1 <= 16
        if c.finish_reason == "length":
            assert len(c.tokens) == r.max_new_tokens
        elif c.finish_reason == "capacity":
            assert plen + len(c.tokens) - 1 == 16
        assert c.finished_s >= c.admitted_s >= 0.0


@pytest.mark.parametrize("slots,n,max_new,seed", [
    (1, 4, 3, 0),       # one at a time: pure queueing
    (3, 7, 4, 1),       # more requests than slots: retire and refill
    (4, 2, 1, 2),       # budget 1: retirement at admission
])
def test_slot_lifecycle_invariants(slots, n, max_new, seed):
    _check_lifecycle(slots, n, max_new, seed)


try:
    import hypothesis
    import hypothesis.strategies as st
    from hypothesis import given, settings

    @settings(max_examples=6, deadline=None,
              suppress_health_check=list(hypothesis.HealthCheck))
    @given(slots=st.integers(1, 4), n=st.integers(1, 9),
           max_new=st.integers(1, 5), seed=st.integers(0, 2 ** 20))
    def test_slot_lifecycle_hypothesis(slots, n, max_new, seed):
        _check_lifecycle(slots, n, max_new, seed)
except ImportError:
    @pytest.mark.skip(reason="hypothesis not installed")
    def test_slot_lifecycle_hypothesis():
        pass
