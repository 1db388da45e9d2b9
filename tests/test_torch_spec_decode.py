"""The port's speculative decoding against the JAX package's, on the CPU.

The same weights (numpy-seeded, `params_from_jax`) and prompts go through
the JAX `spec_generate` / verify windows and the port's. Held exactly:
- `NgramDrafter` proposals and `commit_window` outputs for seeded
  histories and windows;
- greedy `spec_generate` (dense, left-padded buckets, with eos, with the
  n-gram drafter, the draft model and the adaptive controller) gives the
  JAX tokens and the port's own `generate` tokens (f32: logits differ by
  sum order only, far below the argmax gaps of these prompts);
- one paged verify window gives the JAX window's targets and accepts,
  with logits and pool within 1e-4, and a paged window loop gives the
  port's `generate` tokens;
- sampled `spec_generate` gives the port's own sampled `generate` tokens
  (per-row seeds: the draws differ from jax.random's by construction), and
  a scalar seed raises;
- `draft_config` and `derive_draft_params` equal JAX's;
- `AdaptiveSpecController` walks the same K trajectory."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polyaxon_tpu.models import draft as jdraft
from polyaxon_tpu.models import spec_decode as jspec
from polyaxon_tpu.models.generate import make_paged_cache as jax_make_paged_cache
from polyaxon_tpu.models.kv_pages import PagedKVLayout as JLayout
from polyaxon_tpu.serving.adaptive import AdaptiveSpecController as JController
from polyaxon_tpu_torch.models import draft as tdraft
from polyaxon_tpu_torch.models import spec_decode as tspec
from polyaxon_tpu_torch.models.convert import params_from_jax
from polyaxon_tpu_torch.models.generate import generate, make_paged_cache
from polyaxon_tpu_torch.models.kv_pages import PagedKVLayout
from polyaxon_tpu_torch.models.transformer import _make_config
from polyaxon_tpu_torch.serving.adaptive import AdaptiveSpecController
from tests.test_torch_transformer import LOGIT_TOL, jax_lm, torch_lm


@pytest.fixture(scope="module")
def pair():
    module, params = jax_lm({"attention": "xla"})
    return module, params, torch_lm(module, params)


def _repetitive(rng, B, P):
    """Prompts with repeated spans, so the n-gram drafts are accepted
    sometimes and rejected sometimes."""
    out = np.zeros((B, P), np.int64)
    for b in range(B):
        motif = rng.integers(1, 256, int(rng.integers(3, 7)))
        row = np.concatenate([motif] * (P // len(motif) + 1))[:P]
        row[rng.integers(0, P, 3)] = rng.integers(1, 256, 3)
        out[b] = row
    return out


def test_ngram_drafter_matches_jax():
    rng = np.random.default_rng(0)
    for trial in range(20):
        hist = rng.integers(0, 6, int(rng.integers(0, 30))).tolist()
        ours, ref = tspec.NgramDrafter(hist), jspec.NgramDrafter(hist)
        for _ in range(4):
            k = int(rng.integers(1, 6))
            assert ours.propose(k) == ref.propose(k)
            more = rng.integers(0, 6, int(rng.integers(1, 4))).tolist()
            ours.extend(more)
            ref.extend(more)


def test_commit_window_matches_jax():
    rng = np.random.default_rng(1)
    for trial in range(30):
        B, K = int(rng.integers(1, 5)), int(rng.integers(1, 5))
        fed = rng.integers(0, 4, (B, K + 1))
        targets = rng.integers(0, 4, (B, K + 1))
        accept = np.cumprod(fed[:, 1:] == targets[:, :-1], axis=1).sum(axis=1)
        remaining = rng.integers(-1, K + 3, B)
        done = rng.random(B) < 0.3
        eos = int(rng.integers(0, 4)) if trial % 2 else None
        ours = tspec.commit_window(fed, targets, accept, remaining, done, eos)
        ref = jspec.commit_window(fed, targets, accept, remaining, done, eos)
        assert [c.tolist() for c in ours[0]] == [c.tolist() for c in ref[0]]
        for a, b in zip(ours[1:4], ref[1:4]):
            np.testing.assert_array_equal(a, b)
        assert ours[4] == ref[4]


def _jax_spec(pair, prompt, **kw):
    module, params, _ = pair
    return np.asarray(jspec.spec_generate(module, params, jnp.asarray(prompt), **kw))


@pytest.mark.parametrize("case", ["plain", "bucketed-eos"])
def test_greedy_spec_generate_matches_jax_and_generate(pair, case):
    _, _, model = pair
    rng = np.random.default_rng(2)
    prompt = _repetitive(rng, 3, 14)
    kw = dict(max_new_tokens=12, draft_tokens=3)
    lengths = None
    if case == "bucketed-eos":
        lengths = np.array([14, 9, 5])
        for b, n in enumerate(lengths):
            prompt[b, :14 - n] = 0
        free = generate(model, torch.from_numpy(prompt), max_new_tokens=12,
                        prompt_lengths=torch.from_numpy(lengths)).numpy()
        kw["eos_id"] = int(free[1, 14 + 4])  # a token row 1 really generates
        kw["prompt_lengths"] = lengths
    stats = {}
    out = tspec.spec_generate(model, torch.from_numpy(prompt), stats=stats, **kw).numpy()
    ref = _jax_spec(pair, prompt, **kw)
    np.testing.assert_array_equal(out, ref)
    plain = generate(model, torch.from_numpy(prompt), max_new_tokens=12,
                     eos_id=kw.get("eos_id"),
                     prompt_lengths=None if lengths is None else torch.from_numpy(lengths))
    np.testing.assert_array_equal(out, plain.numpy())
    assert stats["proposed"] > 0 and stats["windows"] < 3 * 11


def test_greedy_spec_generate_with_draft_model_matches_jax(pair):
    """The draft model (half depth, by layer truncation) proposes; the
    tokens are JAX's and the port's plain generate's, and a draft equal to
    the target (no truncation) is accepted every time."""
    module, params, model = pair
    rng = np.random.default_rng(3)
    prompt = rng.integers(1, 256, (2, 10))
    lengths = np.array([10, 6])
    prompt[1, :4] = 0
    kw = dict(max_new_tokens=10, draft_tokens=3, prompt_lengths=lengths)
    dmod, derived = tdraft.build_draft(model)
    assert derived and dmod.cfg.n_layers == 1
    seeds = np.array([0, 0])
    stats = {}
    drafter = tdraft.ModelDrafter(dmod, prompt, lengths, seeds=seeds)
    out = tspec.spec_generate(model, torch.from_numpy(prompt), drafter=drafter,
                              stats=stats, **kw).numpy()
    jmod, jparams, _ = jdraft.build_draft(module, params)
    jdrafter = jdraft.ModelDrafter(jmod, jparams, jnp.asarray(prompt), lengths,
                                   seeds=seeds)
    ref = _jax_spec(pair, prompt, drafter=jdrafter, **kw)
    np.testing.assert_array_equal(out, ref)
    plain = generate(model, torch.from_numpy(prompt), max_new_tokens=10,
                     prompt_lengths=torch.from_numpy(lengths))
    np.testing.assert_array_equal(out, plain.numpy())
    # the whole model as its own draft: every draft matches its target
    full, _ = tdraft.build_draft(model, overrides={"n_layers": model.cfg.n_layers})
    stats = {}
    tspec.spec_generate(model, torch.from_numpy(prompt), stats=stats,
                        drafter=tdraft.ModelDrafter(full, prompt, lengths, seeds=seeds), **kw)
    assert stats["accepted_judged"] == stats["proposed"]


def test_adaptive_spec_generate_matches_jax(pair):
    """The controller steers K window by window: the same tokens and the
    same K trajectory on both sides (random text: K falls to 0 and back)."""
    module, params, model = pair
    rng = np.random.default_rng(4)
    prompt = rng.integers(1, 256, (2, 8))
    ctl_kw = dict(k_init=3, k_min=1, k_max=4, window=4, reprobe=3)
    ours_ctl, ref_ctl = AdaptiveSpecController(**ctl_kw), JController(**ctl_kw)
    kw = dict(max_new_tokens=24, draft_tokens=4)
    out = tspec.spec_generate(model, torch.from_numpy(prompt), controller=ours_ctl,
                              **kw).numpy()
    ref = _jax_spec(pair, prompt, controller=ref_ctl, **kw)
    np.testing.assert_array_equal(out, ref)
    assert ours_ctl.stats() == ref_ctl.stats()
    assert ours_ctl.stats()["disables"] >= 1


def test_sampled_spec_generate_equals_sampled_generate(pair):
    _, _, model = pair
    prompt = torch.from_numpy(_repetitive(np.random.default_rng(5), 3, 12))
    seeds = [4, 9, 2]
    kw = dict(max_new_tokens=10, temperature=0.9, top_k=20)
    out = tspec.spec_generate(model, prompt, draft_tokens=3, seeds=seeds, **kw)
    assert torch.equal(out, generate(model, prompt, seed=seeds, **kw))
    dmod, _ = tdraft.build_draft(model)
    drafter = tdraft.ModelDrafter(dmod, prompt, [12] * 3, seeds=seeds, temperature=0.9,
                                  top_k=20)
    out = tspec.spec_generate(model, prompt, draft_tokens=3, seeds=seeds,
                              drafter=drafter, **kw)
    assert torch.equal(out, generate(model, prompt, seed=seeds, **kw))
    with pytest.raises(ValueError, match="per-row seeds"):
        tspec.spec_generate(model, prompt, draft_tokens=3, **kw)


def test_paged_verify_window_matches_jax(pair):
    """A paged prefill then one verify window of K = 3 drafts at per-row
    frontiers, both sides on pools of the same layout."""
    module, params, model = pair
    pt, pb, K = 4, 8, 3
    jl, tl = JLayout(pt, 32), PagedKVLayout(pt, 32)
    cache_j = jax_make_paged_cache(module, params, jl)
    cache_t = make_paged_cache(model, tl)
    rng = np.random.default_rng(6)
    prompt = _repetitive(rng, 2, pb)
    pad = np.array([0, 3])
    prompt[1, :3] = 0
    pages = np.array([[1, 2, 3, 4, 5], [6, 7, 8, 9, 10]])
    seeds = np.array([1, 2])
    logits, out_vars = module.apply(
        {"params": params, "cache": cache_j}, jnp.asarray(prompt, jnp.int32), train=False,
        decode=True, mutable=["cache"], kv_layout=jl, pad=jnp.asarray(pad, jnp.int32),
        pages=jnp.asarray(pages, jnp.int32), pos=jnp.asarray(0, jnp.int32))
    cache_j = out_vars["cache"]
    with torch.inference_mode():
        model(torch.from_numpy(prompt), cache=cache_t, kv_layout=tl, pos=0,
              pad=torch.from_numpy(pad), pages=torch.from_numpy(pages))
    first = np.asarray(logits)[:, -1].argmax(-1)
    fed = np.stack([np.concatenate([[first[b]], tspec.NgramDrafter(
        list(prompt[b]) + [first[b]]).propose(K)]) for b in range(2)])
    pos = np.array([pb, pb])
    start_g = np.array([1, 1])
    done = np.zeros(2, bool)
    fn = jspec.jit_spec_verify_paged(module, kv_layout=jl, prefix_len=0, temperature=0.0,
                                     top_k=None, eos_id=None)
    cache_j, tgt_j, acc_j = fn(params, cache_j, jnp.asarray(fed, jnp.int32),
                               jnp.asarray(done), jnp.asarray(pad, jnp.int32),
                               jnp.asarray(pages, jnp.int32), jnp.asarray(seeds, jnp.int32),
                               jnp.asarray(pos, jnp.int32), jnp.asarray(start_g, jnp.int32))
    tgt_t, acc_t = tspec.spec_verify_paged(
        model, cache_t, fed, done, pad, pages, seeds, pos, start_g, kv_layout=tl,
        temperature=0.0, top_k=None, eos_id=None)
    np.testing.assert_array_equal(tgt_t, np.asarray(tgt_j))
    np.testing.assert_array_equal(acc_t, np.asarray(acc_j))
    ref_pool = np.asarray(cache_j["layer_1"]["attention"]["cached_key"])
    live = pages.ravel()
    np.testing.assert_allclose(cache_t[1][0].numpy()[live], ref_pool[live],
                               atol=LOGIT_TOL, rtol=LOGIT_TOL)


def test_paged_window_loop_equals_generate(pair):
    """Verify windows through the page tables, rows at their own
    frontiers and prefix widths, with eos: the tokens of plain generate."""
    _, _, model = pair
    pt, K, new = 4, 3, 10
    rng = np.random.default_rng(7)
    rows = [_repetitive(rng, 1, n)[0].tolist() for n in (11, 6, 9)]
    free = [generate(model, torch.tensor([r]), max_new_tokens=new)[0].tolist() for r in rows]
    eos = free[0][11 + 5]
    ref = [generate(model, torch.tensor([r]), max_new_tokens=new, eos_id=eos)[0].tolist()
           for r in rows]
    layout = PagedKVLayout(pt, 64)
    cache = make_paged_cache(model, layout)
    pb = 12
    n_pages = layout.pages_for(pb + new + K)
    tables = 1 + np.arange(3 * n_pages).reshape(3, n_pages)
    arr = np.zeros((3, pb), np.int64)
    pads = np.array([pb - len(r) for r in rows])
    for b, r in enumerate(rows):
        arr[b, pads[b]:] = r
    with torch.inference_mode():
        logits = model(torch.from_numpy(arr), cache=cache, kv_layout=layout, pos=0,
                       pad=torch.from_numpy(pads), pages=torch.from_numpy(tables))
    first = logits[:, -1].argmax(-1).numpy()
    gen = [[int(t)] for t in first]
    drafters = [tspec.NgramDrafter(r + [int(first[b])]) for b, r in enumerate(rows)]
    tok, pos, g = first.copy(), np.full(3, pb), np.ones(3, np.int64)
    done, remaining = np.zeros(3, bool), np.full(3, new - 1)
    for b in range(3):
        if first[b] == eos:
            gen[b] += [eos] * int(remaining[b])
            remaining[b] = 0
    while (remaining > 0).any():
        fed = np.stack([[tok[b]] + (drafters[b].propose(K) if remaining[b] > 0
                                    else [tok[b]] * K) for b in range(3)])
        targets, accept = tspec.spec_verify_paged(
            model, cache, fed, done, pads, tables, [0, 0, 0], pos, g, kv_layout=layout,
            prefix_lens=[0, 0, 0], temperature=0.0, top_k=None, eos_id=eos)
        committed, done, remaining, eos_hit, _ = tspec.commit_window(
            fed, targets, accept, remaining, done, eos)
        for b in range(3):
            toks = committed[b]
            if not len(toks):
                continue
            gen[b] += toks.tolist()
            drafters[b].extend(toks)
            tok[b], pos[b], g[b] = toks[-1], pos[b] + len(toks), g[b] + len(toks)
            if eos_hit[b] and remaining[b] > 0:
                gen[b] += [eos] * int(remaining[b])
                remaining[b] = 0
    assert [r + gen[b] for b, r in enumerate(rows)] == ref


@pytest.mark.parametrize(
    "overrides", [{}, {"n_layers": 1, "dim": 32, "n_heads": 2}, {"n_layers": 2}],
    ids=["default", "narrow", "full-depth"],
)
def test_draft_config_and_params_match_jax(pair, overrides):
    module, params, model = pair
    cfg = dataclasses.replace(model.cfg, draft=tuple(sorted(overrides.items())))
    ours = tdraft.draft_config(cfg)
    ref = jdraft.draft_config(dataclasses.replace(module.cfg, draft=cfg.draft))
    ref_fields = dataclasses.asdict(ref)
    assert {k: v for k, v in dataclasses.asdict(ours).items()} == {
        k: ref_fields[k] for k in dataclasses.asdict(ours)}
    try:
        jp = jdraft.derive_draft_params(params, ref, base_cfg=module.cfg)
    except ValueError as e:
        with pytest.raises(ValueError, match="truncation"):
            tdraft.derive_draft_params(model.state_dict(), ours, base_cfg=model.cfg)
        assert "truncation" in str(e)
        dmod, derived = tdraft.build_draft(model, overrides=overrides)
        assert not derived and dmod.cfg.dim == 32
        return
    mine = tdraft.derive_draft_params(model.state_dict(), ours, base_cfg=model.cfg)
    theirs = params_from_jax(jp, _make_config(dataclasses.asdict(ours)))
    assert mine.keys() == theirs.keys()
    for name in mine:
        torch.testing.assert_close(mine[name], theirs[name], rtol=0, atol=0)
    with pytest.raises(ValueError, match="tokenizer"):
        tdraft.draft_config(dataclasses.replace(cfg, draft=(("vocab_size", 7),)))


def test_adaptive_controller_trajectory_matches_jax():
    rng = np.random.default_rng(8)
    kw = dict(k_init=4, k_min=1, k_max=8, window=16, reprobe=5)
    ours, ref = AdaptiveSpecController(**kw), JController(**kw)
    trace = []
    for step in range(300):
        assert ours.window_k() == ref.window_k()
        k = ours.window_k()
        if k == 0:
            ours.tick_plain(1)
            ref.tick_plain(1)
        else:
            rate = 0.9 if (step // 60) % 2 else 0.03  # copy-friendly, then novel
            prop = k * 2
            acc = int(rng.binomial(prop, rate))
            ours.observe(prop, acc, accepted_raw=acc - 1 if acc else 0)
            ref.observe(prop, acc, accepted_raw=acc - 1 if acc else 0)
        trace.append(k)
    assert ours.stats() == ref.stats()
    assert 0 in trace and max(trace) > 4
    with pytest.raises(ValueError):
        AdaptiveSpecController(k_init=9, k_max=8)
