"""Port parity: the serving schedulers.

The workloads of ``tests/unit/test_scheduler.py`` (chunked prefill, SLO
classes, deadlines at chunk boundaries, speculative decoding) and
``tests/unit/test_serving_chunked.py`` (``decode_chunk`` > 1) run through
the JAX engine and the port's, fp32 on the CPU, from the same
JAX-initialised weights: greedy tokens must be IDENTICAL, and so must the
scheduler's counters.  The port's on-device sampler draws from its own
counter-based stream (not JAX's threefry), so sampled tokens are held to
what must hold instead: ``top_k=1`` equals greedy, the tokens that
survive top-k / top-p are the ones JAX's ``one_sample`` keeps, a
request's stream depends only on (seed, tokens generated so far), and
the draws follow the filtered distribution.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference.serving import ServingEngine as JaxServing
from deepspeed_tpu.models.transformer import (
    CausalTransformerLM as JaxLM, TransformerConfig as JaxConfig)
from deepspeed_tpu_torch.inference.robustness import RequestRejected
from deepspeed_tpu_torch.inference.scheduler import (SchedulerConfig,
                                                     filter_logits,
                                                     sample_tokens,
                                                     uniform_noise)
from deepspeed_tpu_torch.inference.serving import ServingEngine
from deepspeed_tpu_torch.models.convert import from_jax_params
from deepspeed_tpu_torch.models.transformer import (CausalTransformerLM,
                                                    TransformerConfig)
from torch_threads import _one_torch_thread  # noqa: F401

KW = dict(hidden_size=64, n_heads=4, n_kv_heads=2)
CHUNKED = {"policy": "chunked", "prefill_chunk_tokens": 8}


def _port_model(params, cfg):
    m = CausalTransformerLM(cfg, device="cpu")
    m.load_state_dict(from_jax_params(
        jax.tree_util.tree_map(np.asarray, params), cfg))
    return m


@pytest.fixture(scope="module")
def tiny():
    jmodel = JaxLM(JaxConfig.tiny(**KW))
    params = jmodel.init(jax.random.key(0))
    cold = jmodel.init(jax.random.key(9))       # a draft from another seed
    cfg = TransformerConfig.tiny(**KW)
    return (cfg, jmodel, params, _port_model(params, cfg), cold,
            _port_model(cold, cfg))


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def tick(self, dt=1.0):
        self.t += dt


def _prompts(cfg, seed, lengths):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, (n,)).tolist()
            for n in lengths]


def _engines(tiny, sched=None, draft=None, **kw):
    """(JAX engine, port engine) over the same weights and config;
    ``draft``: "cold" (another seed) or "self" (the target's weights)."""
    cfg, jmodel, params, tmodel, cold, tcold = tiny
    kw.setdefault("max_batch", 4)
    kw.setdefault("page_size", 8)
    kw.setdefault("max_seq", 64)
    serving = {"scheduler": sched or {}}
    jdraft = {}
    tdraft = {}
    if draft is not None:
        jdraft = dict(draft_model=jmodel,
                      draft_params=cold if draft == "cold" else params)
        tdraft = dict(draft_model=tcold if draft == "cold" else tmodel)
    jclock, tclock = kw.pop("clocks", (None, None))
    jeng = JaxServing(jmodel, params, dtype=jnp.float32, clock=jclock,
                      serving=dict(serving, attention_backend="jnp"),
                      **jdraft, **kw)
    teng = ServingEngine(tmodel, dtype=torch.float32, clock=tclock,
                         serving=serving, **tdraft, **kw)
    return jeng, teng


def _same_stats(jeng, teng):
    """Every scheduler counter the JAX engine keeps, equal in the port."""
    js, ts = jeng.scheduler.sched_stats, teng.scheduler.sched_stats
    assert {k: ts[k] for k in js} == js


def _charge_dispatches(eng, cost=1.0):
    """Every target dispatch advances the engine's FakeClock by ``cost``
    seconds: scheduling latency in simulated dispatch time."""
    real = eng._run_step

    def charged(ids, tables, lengths, *a, **k):
        eng._clock.t += cost
        return real(ids, tables, lengths, *a, **k)

    eng._run_step = charged


# ----------------------------------------------------------------------
# config + wiring
# ----------------------------------------------------------------------
def test_config_validation():
    for bad in ({"policy": "round-robin"}, {"prefill_chunk_tokens": 0},
                {"slo_class_default": "gold"},
                {"slo_classes": {"platinum": {}}}):
        with pytest.raises(ValueError):
            SchedulerConfig(bad)
    cfg = SchedulerConfig({"slo_classes":
                           {"latency": {"default_deadline_s": 2.0}}})
    assert cfg.class_deadline_s("latency") == 2.0
    assert cfg.class_deadline_s("throughput") is None


def test_speculative_requires_chunked_and_a_draft(tiny):
    tmodel = tiny[3]
    with pytest.raises(ValueError, match="chunked"):
        ServingEngine(tmodel, max_batch=1, page_size=8, max_seq=32,
                      serving={"scheduler": {"speculative": {
                          "enabled": True}}}, draft_model=tmodel)
    with pytest.raises(ValueError, match="draft_model"):
        ServingEngine(tmodel, max_batch=1, page_size=8, max_seq=32,
                      serving={"scheduler": dict(CHUNKED, speculative={
                          "enabled": True})})
    with pytest.raises(ValueError, match="decode_chunk"):
        ServingEngine(tmodel, max_batch=1, page_size=8, max_seq=32,
                      decode_chunk=2, draft_model=tmodel,
                      serving={"scheduler": dict(CHUNKED, speculative={
                          "enabled": True})})


# ----------------------------------------------------------------------
# chunked prefill
# ----------------------------------------------------------------------
@pytest.mark.parametrize("chunk,lengths", [
    (8, (5, 20, 3, 33)), (4, (5, 11, 3, 17)), (16, (40, 2, 16, 17))])
def test_chunked_identical_to_jax_and_monolithic(tiny, chunk, lengths):
    cfg = tiny[0]
    prompts = _prompts(cfg, 0, lengths)
    sched = {"policy": "chunked", "prefill_chunk_tokens": chunk}
    jeng, teng = _engines(tiny, sched)
    got = teng.generate(prompts, max_new_tokens=6)
    assert got == jeng.generate(prompts, max_new_tokens=6)
    _, mono = _engines(tiny)
    assert mono.generate(prompts, max_new_tokens=6) == got
    _same_stats(jeng, teng)
    assert teng.scheduler.sched_stats["prefills_split"] > 0
    assert teng.leak_report() == {}


def test_chunked_continuous_batching_with_eos(tiny):
    cfg = tiny[0]
    prompts = _prompts(cfg, 1, (4, 9, 6, 12, 5, 7, 10, 3))
    _, ref = _engines(tiny, CHUNKED, max_batch=2)
    first = ref.generate(prompts, max_new_tokens=6)
    eos = first[2][len(prompts[2]) + 1]
    jeng, teng = _engines(tiny, CHUNKED, max_batch=2, eos_token_id=eos)
    got = teng.generate(prompts, max_new_tokens=6)
    assert got == jeng.generate(prompts, max_new_tokens=6)
    assert got[2][-1] == eos and len(got[2]) == len(prompts[2]) + 2
    _same_stats(jeng, teng)
    assert teng.leak_report() == {}


def test_chunked_interleaves_decode_with_long_prefill(tiny):
    """A short request keeps decoding while a long one prefills a chunk a
    step: its tokens are out before the long prompt's first token, on
    both engines, at the same step."""
    cfg = tiny[0]
    short, long_ = _prompts(cfg, 2, (4, 40))
    done_at = {}
    for name, eng in zip(("jax", "port"), _engines(tiny, CHUNKED,
                                                    max_batch=2)):
        eng.add_request("short", short, max_new_tokens=3)
        eng.step()
        eng.add_request("long", long_, max_new_tokens=2)
        order = []
        for step in range(30):
            for rid in eng.step():
                order.append((rid, step))
            if not (eng.queue or eng.n_active):
                break
        done_at[name] = order
        assert eng.leak_report() == {}
    assert done_at["port"] == done_at["jax"]
    assert [r for r, _ in done_at["port"]] == ["short", "long"]


def test_slo_class_orders_admission_and_rejects_unknown(tiny):
    cfg = tiny[0]
    pa, pb, pc = _prompts(cfg, 3, (4, 5, 6))
    orders = []
    for eng in _engines(tiny, CHUNKED, max_batch=1, max_seq=32):
        eng.add_request("busy", pa, max_new_tokens=2)
        eng.step()
        eng.add_request("batch", pb, max_new_tokens=2,
                        slo_class="throughput")
        eng.add_request("chat", pc, max_new_tokens=2, slo_class="latency")
        while eng.queue or eng.n_active:
            eng.step()
        orders.append([t.req_id for t in eng.tracer.completed])
    assert orders[1] == orders[0]
    assert orders[1].index("chat") < orders[1].index("batch")
    with pytest.raises(RequestRejected) as e:
        eng.add_request("x", pa, max_new_tokens=2, slo_class="gold")
    assert e.value.reason == "bad_request"


def test_deadline_cancels_mid_prefill_and_drains_to_zero(tiny):
    cfg = tiny[0]
    (p,) = _prompts(cfg, 4, (33,))
    clocks = (FakeClock(), FakeClock())
    engines = _engines(tiny, CHUNKED, max_batch=1, clocks=clocks)
    chunks = []
    for clk, eng in zip(clocks, engines):
        eng.add_request("r", p, max_new_tokens=4, deadline_s=2.5)
        for _ in range(8):
            clk.tick(1.0)
            eng.step()
            if not eng.n_active:
                break
        assert eng.n_active == 0 and not eng.queue
        assert eng.stats["deadline"] == 1
        tr = list(eng.tracer.completed)[-1]
        assert tr.terminal == "deadline" and tr.t_first_token < 0
        chunks.append(eng.scheduler.sched_stats["prefill_chunks"])
        assert eng.leak_report() == {}
        assert eng.alloc.available_page_count == eng.alloc.num_pages - 1
    assert chunks[1] == chunks[0] and 0 < chunks[1] < 5


def test_deadline_checked_between_chunks_within_one_step(tiny):
    """With max_prefill_chunks_per_step covering the whole prompt, the TTL
    check at each chunk boundary stops the prefill inside ONE step."""
    cfg = tiny[0]
    (p,) = _prompts(cfg, 5, (48,))
    clocks = (FakeClock(), FakeClock())
    sched = dict(CHUNKED, max_prefill_chunks_per_step=8)
    for eng in _engines(tiny, sched, max_batch=1, clocks=clocks):
        _charge_dispatches(eng, cost=1.0)    # each chunk costs 1 s
        eng.add_request("r", p, max_new_tokens=2, deadline_s=2.5)
        eng.step()
        assert eng.n_active == 0 and eng.stats["deadline"] == 1
        assert eng.scheduler.sched_stats["prefill_chunks"] == 3
        assert eng.leak_report() == {}


def test_class_default_ttl_applies(tiny):
    cfg = tiny[0]
    pa, pb = _prompts(cfg, 6, (4, 5))
    clocks = (FakeClock(), FakeClock())
    sched = dict(CHUNKED, slo_classes={"latency": {"default_deadline_s":
                                                   2.0}})
    for clk, eng in zip(clocks, _engines(tiny, sched, max_batch=1,
                                         max_seq=32, clocks=clocks)):
        eng.add_request("busy", pa, max_new_tokens=8,
                        slo_class="throughput")
        eng.step()
        eng.add_request("chat", pb, max_new_tokens=2, slo_class="latency")
        for _ in range(10):
            clk.tick(1.0)
            eng.step()
            if not (eng.queue or eng.n_active):
                break
        tr = {t.req_id: t for t in eng.tracer.completed}
        assert tr["chat"].terminal == "deadline"
        assert tr["busy"].terminal == "finish" and \
            tr["busy"].n_generated == 8
        assert eng.leak_report() == {}


@pytest.mark.parametrize("decode_chunk", [1, 4])
def test_drain_budgets_pending_chunks(tiny, decode_chunk):
    cfg = tiny[0]
    prompts = _prompts(cfg, 12, (30, 5, 17))
    res = []
    for eng in _engines(tiny, CHUNKED, max_batch=2,
                        decode_chunk=decode_chunk):
        for i, p in enumerate(prompts):
            eng.add_request(i, p, max_new_tokens=5)
        eng.step()
        out = eng.drain()
        res.append((sorted(out["finished"].items()), out["shed"],
                    out["steps"]))
        assert eng.leak_report() == {} and eng.alloc.seq_pages == {}
    assert res[1] == res[0]


# ----------------------------------------------------------------------
# speculative decoding
# ----------------------------------------------------------------------
@pytest.mark.parametrize("draft", ["self", "cold"])
def test_spec_identical_to_jax(tiny, draft):
    """Greedy speculative decoding with a perfect draft (the target's own
    weights: every window accepted) and a cold one (another seed): the
    tokens equal the JAX engine's and the monolithic run's, and so do the
    proposed / accepted counts."""
    cfg = tiny[0]
    prompts = _prompts(cfg, 7, (5, 12, 3))
    sched = dict(CHUNKED, speculative={"enabled": True,
                                       "num_draft_tokens": 3})
    jeng, teng = _engines(tiny, sched, draft=draft)
    got = teng.generate(prompts, max_new_tokens=8)
    assert got == jeng.generate(prompts, max_new_tokens=8)
    _, mono = _engines(tiny)
    assert mono.generate(prompts, max_new_tokens=8) == got
    _same_stats(jeng, teng)
    snap = teng.scheduler.snapshot()
    if draft == "self":
        assert snap["spec_acceptance_rate"] == 1.0
    else:
        assert snap["spec_acceptance_rate"] < 0.5
    # draft calls: gamma + 1 per window, one per draft prefill chunk
    st = teng.scheduler.sched_stats
    assert st["draft_calls"] == 4 * st["spec_windows"] + \
        sum(-(-len(p) // 8) for p in prompts)
    assert teng.leak_report() == {} and jeng.leak_report() == {}


def test_spec_sampling_requests_ride_nonspeculative(tiny):
    """Temperature > 0 requests keep the host RNG stream: window 0 next to
    speculative greedy neighbours, tokens equal to the non-speculative
    engine's and the JAX engine's."""
    cfg = tiny[0]
    pa, pb = _prompts(cfg, 8, (6, 7))

    def run(eng):
        eng.add_request("greedy", pa, max_new_tokens=6)
        eng.add_request("sampled", pb, max_new_tokens=6,
                        temperature=0.8, seed=123)
        out = {}
        while eng.queue or eng.n_active:
            for rid, toks in eng.step().items():
                out.setdefault(rid, []).extend(toks)
        assert eng.leak_report() == {}
        return out

    sched = dict(CHUNKED, speculative={"enabled": True,
                                       "num_draft_tokens": 3})
    jeng, teng = _engines(tiny, sched, draft="self", max_batch=2)
    _, base = _engines(tiny, CHUNKED, max_batch=2)
    got = run(teng)
    assert got == run(jeng) == run(base)


# ----------------------------------------------------------------------
# decode_chunk > 1: the K-step device loop and its sampler
# ----------------------------------------------------------------------
@pytest.mark.parametrize("chunk,max_new", [(2, 6), (4, 6), (4, 8), (2, 5),
                                           (4, 7)])
def test_decode_chunk_greedy_identical(tiny, chunk, max_new):
    cfg = tiny[0]
    prompts = _prompts(cfg, 0, (5, 11, 3, 17))
    jeng, teng = _engines(tiny, decode_chunk=chunk)
    got = teng.generate(prompts, max_new_tokens=max_new)
    assert got == jeng.generate(prompts, max_new_tokens=max_new)
    _, mono = _engines(tiny)
    assert mono.generate(prompts, max_new_tokens=max_new) == got
    _same_stats(jeng, teng)
    # one prefill per prompt, K model calls per decode dispatch
    assert teng.stats["model_calls"] == \
        len(prompts) + chunk * teng.scheduler.sched_stats["decode_steps"]
    assert teng.leak_report() == {}


def test_chunked_with_decode_chunk_identical_to_jax(tiny):
    """Chunked prefill and a 4-token decode dispatch together."""
    cfg = tiny[0]
    prompts = _prompts(cfg, 13, (5, 20, 3, 33, 9))
    jeng, teng = _engines(tiny, CHUNKED, max_batch=2, decode_chunk=4)
    got = teng.generate(prompts, max_new_tokens=7)
    assert got == jeng.generate(prompts, max_new_tokens=7)
    _, mono = _engines(tiny, max_batch=2)
    assert mono.generate(prompts, max_new_tokens=7) == got
    _same_stats(jeng, teng)
    assert teng.leak_report() == {}


def test_decode_chunk_continuous_batching_and_eos(tiny):
    cfg = tiny[0]
    prompts = _prompts(cfg, 1, (4, 9, 6, 12, 5, 7, 10, 3))
    _, ref = _engines(tiny, max_batch=2)
    first = ref.generate(prompts, max_new_tokens=5)
    eos = first[1][len(prompts[1]) + 2]
    jeng, teng = _engines(tiny, max_batch=2, decode_chunk=4,
                          eos_token_id=eos)
    got = teng.generate(prompts, max_new_tokens=5)
    assert got == jeng.generate(prompts, max_new_tokens=5)
    assert got[1][-1] == eos and len(got[1]) == len(prompts[1]) + 3
    assert len(teng.alloc.free) == teng.alloc.num_pages - 1
    assert teng.leak_report() == {}


@pytest.mark.parametrize("chunk", [2, 4])
def test_decode_chunk_top_k_one_equals_greedy(tiny, chunk):
    cfg = tiny[0]
    prompts = _prompts(cfg, 8, (6, 9))
    _, greedy = _engines(tiny, decode_chunk=chunk)
    _, topk1 = _engines(tiny, decode_chunk=chunk)
    want = greedy.generate(prompts, max_new_tokens=6)
    assert topk1.generate(prompts, max_new_tokens=6, temperature=0.7,
                          top_k=1) == want


def _one_sample_survivors(logits, temp, top_k, top_p):
    """numpy copy of the JAX engine's ``one_sample`` filter: the tokens
    left with a finite logit (float32, stable descending argsort)."""
    V = logits.shape[-1]
    l = (logits / np.float32(max(temp, 1e-6))).astype(np.float32)
    order = np.argsort(-l, kind="stable")
    ranks = np.zeros(V, np.int64)
    ranks[order] = np.arange(V)
    k_eff = top_k if 0 < top_k < V else V
    l = np.where(ranks < k_eff, l, np.float32(-1e30)).astype(np.float32)
    p = np.exp(l - l.max())
    p = (p / p.sum()).astype(np.float32)
    cs = np.cumsum(p[order], dtype=np.float32)
    cut = int(np.sum(cs < top_p) + 1) if top_p < 1.0 else V
    # a token survives both stages: ranked under k_eff and under cut
    return set(np.nonzero(ranks < min(k_eff, cut))[0].tolist())


@pytest.mark.parametrize("temp,top_k,top_p", [
    (1.0, 0, 0.9), (0.7, 5, 1.0), (1.5, 3, 0.9), (0.8, 40, 0.5),
    (2.0, 0, 0.999), (1.0, 1, 0.3)])
def test_survivor_sets_equal_jax_one_sample(temp, top_k, top_p):
    rng = np.random.default_rng(31)
    logits = rng.normal(0.0, 3.0, (6, 256)).astype(np.float32)
    B = logits.shape[0]
    out = filter_logits(torch.as_tensor(logits),
                        torch.full((B,), temp), torch.full((B,), top_k),
                        torch.full((B,), top_p))
    for b in range(B):
        got = set(torch.nonzero(out[b] > -1e29)[:, 0].tolist())
        assert got == _one_sample_survivors(logits[b], temp, top_k, top_p)
    # JAX's own filter on the same logits (jnp arithmetic, float32)
    l = jnp.asarray(logits[0]) / max(temp, 1e-6)
    order = jnp.argsort(-l, stable=True)
    ranks = jnp.zeros(256, jnp.int32).at[order].set(jnp.arange(256))
    k_eff = top_k if 0 < top_k < 256 else 256
    l = jnp.where(ranks < k_eff, l, -1e30)
    cs = jnp.cumsum(jax.nn.softmax(l)[order])
    cut = int(jnp.sum(cs < top_p) + 1) if top_p < 1.0 else 256
    want = set(np.nonzero(np.asarray(ranks) < min(k_eff, cut))[0].tolist())
    assert set(torch.nonzero(out[0] > -1e29)[:, 0].tolist()) == want


def test_decode_chunk_sampled_tokens_in_allowed_support(tiny):
    """Every token drawn by the device sampler lies in the top-k / top-p
    support of the dense logits at its position."""
    cfg, _, _, tmodel = tiny[:4]
    (p,) = _prompts(cfg, 6, (5,))
    _, eng = _engines(tiny, max_batch=1, decode_chunk=4)
    eng.add_request("x", p, max_new_tokens=8, temperature=1.5, seed=3,
                    top_k=3, top_p=0.9)
    done = {}
    while eng.queue or eng.n_active:
        done.update(eng.step())
    got = done["x"]
    assert len(got) == len(p) + 8
    seq = list(p)
    for tok in got[len(p):]:
        with torch.no_grad():
            logits = tmodel.apply(torch.as_tensor([seq]))[0, -1].numpy()
        assert tok in _one_sample_survivors(logits, 1.5, 3, 0.9)
        seq.append(tok)


def test_decode_chunk_seed_contract(tiny):
    """A sampled request's tokens depend on (seed, tokens generated) only:
    the same with another request beside it, in another slot, admitted in
    another order; different for another seed."""
    cfg = tiny[0]
    p, other = _prompts(cfg, 4, (6, 4))

    def run(seed, crowd_first):
        _, eng = _engines(tiny, max_batch=2, decode_chunk=4)
        reqs = [("x", p, dict(temperature=0.8, seed=seed, top_p=0.9))]
        if crowd_first is not None:
            crowd = ("crowd", other, dict(temperature=0.5, seed=99))
            reqs = [crowd] + reqs if crowd_first else reqs + [crowd]
        for rid, prompt, kw in reqs:
            eng.add_request(rid, prompt, max_new_tokens=9, **kw)
        done = {}
        while eng.queue or eng.n_active:
            done.update(eng.step())
        assert eng.leak_report() == {}
        return done["x"]

    a = run(7, None)
    assert run(7, True) == a == run(7, False)
    assert run(8, None) != a
    assert len(a) == len(p) + 9


def test_sampled_frequencies_follow_the_filtered_distribution():
    """20000 draws from one row of logits (counters 0..19999, one seed):
    each token's frequency is within 5 binomial standard deviations of
    its filtered probability (a miss has odds under 1e-6 per token), and
    a filtered-out token is never drawn."""
    logits = torch.tensor([[2.0, 1.5, 1.0, 0.5, 0.0, -0.5, -1.0, -3.0]])
    temp, top_k, top_p = 0.9, 6, 0.95
    N = 20000
    rows = logits.expand(N, -1).contiguous()
    full = lambda v: torch.full((N,), v)     # noqa: E731
    toks = sample_tokens(rows, full(temp), full(1234).long(),
                         torch.arange(N), full(top_k).long(), full(top_p))
    freq = np.bincount(toks.numpy(), minlength=8) / N
    filt = filter_logits(logits, torch.tensor([temp]),
                         torch.tensor([top_k]), torch.tensor([top_p]))
    p = torch.softmax(filt, dim=-1)[0].double().numpy()
    assert (freq[p == 0] == 0).all() and (p == 0).sum() >= 2
    tol = 5 * np.sqrt(p * (1 - p) / N) + 1e-12
    assert (np.abs(freq - p) <= tol).all(), (freq, p)


def test_uniform_noise_is_a_function_of_seed_and_counter():
    seeds = torch.tensor([5, 5, 6, 5])
    counters = torch.tensor([0, 1, 0, 0])
    u = uniform_noise(seeds, counters, 1000)
    assert torch.equal(u[0], u[3])
    assert not torch.equal(u[0], u[1]) and not torch.equal(u[0], u[2])
    assert (u > 0).all() and (u < 1).all()
    # roughly uniform: mean 1/2, variance 1/12
    assert abs(u.mean().item() - 0.5) < 0.02
    assert abs(u.var().item() - 1 / 12) < 0.01
