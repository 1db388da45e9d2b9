"""The port's model zoo against the JAX package's, on the CPU: the MLP,
ResNet (basic and bottleneck blocks), ViT, BERT and seq2seq, each built in
both packages, the port loading the reference's initial params (and
`batch_stats`) through `params_from_jax`, then run on the same numpy inputs
from a seed in training mode: the outputs, the gradients of one scalar of
them, and ResNet's BatchNorm statistics after the step.

Tolerances (all f32; the two sides differ in the order of f32 sums):
- outputs: max |port - ref| over max |ref| within 1e-5, 5e-5 for ResNet
  (BatchNorm divides by per-channel deviations computed as mean(x^2) -
  mean(x)^2 — flax's fast variance, which the port keeps — so sum-order
  noise grows through 8-16 normalisations; read: 7.8e-6 on ResNet-50);
- gradients: the relative Frobenius distance of all gradients together
  within 1e-5, 1e-4 for ResNet (read: 4.6e-5 on one BN scale of ResNet-50),
  and each tensor's max |error| within that share of the largest |grad|
  (a per-tensor relative error would read noise on the key projections'
  biases, whose true gradient is 0: softmax ignores a per-row shift);
- BatchNorm's running statistics: max |error| within 5e-5 of the
  buffer's largest magnitude, as the outputs (read: 1.2e-5 on a running
  variance of ResNet-50's last stage).

`attention: flash` runs the JAX package's Pallas kernels in interpret mode
and the port's plain versions (its CPU path), at a shape the kernels
accept; at ViT-S/16's 196 tokens both raise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as flax_nn

from polyaxon_tpu.models import build_model as jax_build
from polyaxon_tpu_torch.models import build_model
from polyaxon_tpu_torch.models.convert import params_from_jax, zoo_layout
from polyaxon_tpu_torch.models.layers import Conv, collecting, same_padding

rng = np.random.default_rng(0)
IMAGES = rng.normal(size=(4, 32, 32, 3)).astype(np.float32)
CASES = {
    "mlp": ("mlp", {"hidden": [64, 32], "input_dim": 48},
            rng.normal(size=(4, 48)).astype(np.float32)),
    # mnist with `flat: false`: NHWC images, flattened as given
    "mlp-nhwc": ("mlp", {"hidden": [64, 32], "input_dim": 48},
                 rng.normal(size=(4, 4, 4, 3)).astype(np.float32)),
    "resnet18": ("resnet", {"depth": 18, "width": 16, "num_classes": 10,
                            "image_size": 32}, IMAGES),
    "resnet50": ("resnet50", {"width": 8, "num_classes": 10, "image_size": 32}, IMAGES),
    "vit": ("vit", {"preset": "tiny-test", "num_classes": 10}, IMAGES[:2]),
    "vit-flash": ("vit", {"preset": "tiny-test", "num_classes": 10,
                          "attention": "flash"}, IMAGES[:2]),
    "bert": ("bert", {"preset": "tiny-test"},
             rng.integers(0, 1024, (2, 64)).astype(np.int32)),
    "bert-flash": ("bert", {"preset": "tiny-test", "attention": "flash"},
                   rng.integers(0, 1024, (2, 64)).astype(np.int32)),
    "seq2seq": ("seq2seq", {"preset": "tiny-test"},
                rng.integers(2, 1024, (2, 64)).astype(np.int32)),
}
RESNETS = ("resnet18", "resnet50")


def _tol(case):
    return (5e-5, 1e-4) if case in RESNETS else (1e-5, 1e-5)


def _objective(out):
    """A scalar that weighs every output element differently."""
    return (out * out).mean() + 1e-3 * out.sum()


def jax_variables(jax_module, module, x) -> dict:
    """The port module's weights (and BatchNorm buffers) as the reference's
    variables, numpy, by `zoo_layout` read backwards. The tree's structure
    comes from `jax.eval_shape` of flax's init: tracing only, where a
    compiled init costs seconds."""
    shapes = jax.eval_shape(lambda xx: jax_module.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)}, xx,
        train=False), jnp.asarray(x))
    state = {k: v.detach().float().numpy() for k, v in module.state_dict().items()}

    def put(tree, path, value):
        for key in path[:-1]:
            tree = tree.setdefault(key, {})
        tree[path[-1]] = value

    params: dict = {}
    for name, (path, how) in zoo_layout(shapes["params"]).items():
        value = state[name]
        if how is True:
            value = value.T
        elif how:
            value = value.transpose(np.argsort(how))
        put(params, path, np.ascontiguousarray(value))
    variables = {"params": params}
    if "batch_stats" in shapes:
        stats: dict = {}
        for path, _ in jax.tree_util.tree_flatten_with_path(shapes["batch_stats"])[0]:
            keys = tuple(k.key for k in path)
            buffer = {"mean": "running_mean", "var": "running_var"}[keys[-1]]
            put(stats, keys, state[".".join((*keys[:-1], buffer))])
        variables["batch_stats"] = stats
    return variables


def _jax_side(name, cfg, x, module):
    """(outputs, gradients, updated batch_stats) of the reference from the
    port module's weights, numpy."""
    bundle = jax_build(name, dict(cfg))
    variables = jax_variables(bundle.module, module, x)
    extra = {k: variables[k] for k in bundle.mutable}

    def loss(params):
        out, updates = bundle.module.apply(
            {"params": params, **extra}, jnp.asarray(x), train=True,
            mutable=list(bundle.mutable))
        return _objective(out.astype(jnp.float32)), (out, updates)

    (_, (out, updates)), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        variables["params"])
    as_np = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    return variables, np.asarray(out), as_np(grads), as_np(dict(updates))


@pytest.fixture(scope="module")
def runs():
    cache = {}

    def get(case):
        if case not in cache:
            name, cfg, x = CASES[case]
            module = build_model(name, dict(cfg), device="cpu", seed=3).module.train()
            variables, out, grads, updates = _jax_side(name, cfg, x, module)
            with collecting() as box:
                ours = module(torch.from_numpy(x))
            _objective(ours.float()).backward()
            cache[case] = dict(variables=variables, out=out, grads=grads, updates=updates,
                               module=module, ours=ours.detach(), box=box, x=x)
        return cache[case]

    return get


@pytest.mark.parametrize("case", list(CASES))
def test_forward_matches_jax(runs, case):
    r = runs(case)
    err = np.abs(r["ours"].numpy() - r["out"]).max() / np.abs(r["out"]).max()
    assert r["ours"].shape == r["out"].shape
    assert err < _tol(case)[0], err


@pytest.mark.parametrize("case", list(CASES))
def test_gradients_match_jax(runs, case):
    r = runs(case)
    want = params_from_jax(r["grads"], None)
    got = {k: p.grad for k, p in r["module"].named_parameters()}
    assert set(got) == set(want)
    num = sum(((got[k] - want[k]) ** 2).sum() for k in want)
    den = sum((want[k] ** 2).sum() for k in want)
    tol = _tol(case)[1]
    assert (num / den).sqrt().item() < tol
    scale = max(want[k].abs().max().item() for k in want)
    for k in want:
        assert (got[k] - want[k]).abs().max().item() <= tol * scale, k


@pytest.mark.parametrize("case", RESNETS)
def test_batch_stats_after_a_train_step(runs, case):
    """The running statistics the step asks for equal flax's updated
    `batch_stats` (0.9 running + 0.1 batch, the biased variance); the
    collecting forward left the buffers as they were."""
    r = runs(case)
    init = params_from_jax({}, None, r["variables"]["batch_stats"])
    want = params_from_jax({}, None, r["updates"]["batch_stats"])
    buffers = dict(r["module"].named_buffers())
    assert set(buffers) == set(want)
    assert all(torch.equal(buffers[k], init[k]) for k in init)
    updates = {f"{_name(r['module'], m)}.{n}": v for m, n, v in r["box"].updates}
    assert set(updates) == set(want)
    for k in want:
        err = (updates[k] - want[k]).abs().max() / want[k].abs().max()
        assert err.item() < 5e-5, k
    moved = [k for k in want if not torch.equal(want[k], init[k])]
    assert len(moved) == len(want)


def _name(root, module):
    return next(n for n, m in root.named_modules() if m is module)


def test_eval_uses_running_stats(runs):
    """Eval mode normalises by the running statistics, as train=False (the
    BatchNorm of both block kinds is one layer: ResNet-18 holds it)."""
    r = runs("resnet18")
    name, cfg, x = CASES["resnet18"]
    variables = {"params": r["variables"]["params"], **r["updates"]}
    want = np.asarray(jax.jit(lambda v: jax_build(name, dict(cfg)).module.apply(
        v, jnp.asarray(x), train=False))(variables))
    module = build_model(name, dict(cfg), device="cpu").module
    module.load_state_dict(params_from_jax(variables["params"], None,
                                           variables["batch_stats"]))
    with torch.no_grad():
        got = module.eval()(torch.from_numpy(x)).numpy()
    assert np.abs(got - want).max() / np.abs(want).max() < 5e-5


def test_zero_init_scales_and_no_batch_counter():
    module = build_model("resnet", {"depth": 18, "width": 8}, device="cpu").module
    sd = module.state_dict()
    assert not any("num_batches_tracked" in k for k in sd)
    assert torch.count_nonzero(sd["stage1_block0.bn2.weight"]) == 0
    assert torch.all(sd["stage1_block0.bn1.weight"] == 1)
    bottleneck = build_model("resnet50", {"width": 8}, device="cpu").module.state_dict()
    assert torch.count_nonzero(bottleneck["stage2_block0.bn3.weight"]) == 0
    assert torch.all(bottleneck["stage2_block0.proj_bn.weight"] == 1)


@pytest.mark.parametrize("size", [8, 7])
def test_same_padding_at_stride_2(size):
    """A 3x3 stride-2 "SAME" conv pads (0, 1) on an even axis and (1, 1) on
    an odd one, as flax's nn.Conv; torch's symmetric padding=1 is another
    function on the even input."""
    assert same_padding(size, 3, 2) == ((0, 1) if size % 2 == 0 else (1, 1))
    x = np.random.default_rng(1).normal(size=(2, size, size, 5)).astype(np.float32)
    conv = flax_nn.Conv(6, (3, 3), strides=(2, 2), use_bias=False)
    variables = conv.init(jax.random.PRNGKey(0), jnp.asarray(x))
    want = np.asarray(conv.apply(variables, jnp.asarray(x))).transpose(0, 3, 1, 2)
    ours = Conv(5, 6, 3, stride=2, bias=False)
    kernel = torch.tensor(np.asarray(variables["params"]["kernel"]))
    with torch.no_grad():
        ours.weight.copy_(kernel.permute(3, 2, 0, 1))
        xt = torch.from_numpy(x).permute(0, 3, 1, 2)
        got = ours(xt).numpy()
        symmetric = torch.nn.functional.conv2d(xt, ours.weight, stride=2, padding=1).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    if size % 2 == 0:
        assert np.abs(symmetric - want).max() > 1e-2


def test_vit_s16_flash_raises_in_both_packages():
    """196 tokens: the 128-row q block does not divide them; no padding."""
    x = np.zeros((1, 224, 224, 3), np.float32)
    cfg = {"variant": "S/16", "num_classes": 10, "attention": "flash", "n_layers": 1}
    bundle = jax_build("vit", dict(cfg))
    with pytest.raises(ValueError, match="divisible"):
        jax.eval_shape(lambda xx: bundle.module.init(jax.random.PRNGKey(0), xx), x)
    module = build_model("vit", dict(cfg), device="cpu").module
    with pytest.raises(ValueError, match="divisible"):
        module(torch.from_numpy(x))


def test_bert_yaml_keys_build_bert_base(monkeypatch):
    """examples/bert.yaml's num_layers, hidden_dim, num_heads, mlp_dim and
    max_len are not BERT's keys in either package: both build bert-base."""
    cfg = {"num_layers": 2, "hidden_dim": 64, "num_heads": 2, "mlp_dim": 128,
           "vocab_size": 30522, "max_len": 128}
    bundle = jax_build("bert", dict(cfg))
    shapes = jax.eval_shape(
        lambda: bundle.module.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32)))
    n_ref = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes["params"]))
    from polyaxon_tpu_torch.models import bert

    monkeypatch.setattr(bert, "seeded_init", lambda *a, **k: None)  # shapes only
    module = build_model("bert", dict(cfg), device="cpu").module
    assert sum(p.numel() for p in module.parameters()) == n_ref
    assert len(zoo_layout(shapes["params"])) == len(dict(module.named_parameters()))
    assert module.seq_len == 512 and module.embed.weight.shape == (30522, 768)


def test_resnet_mixed_precision_dtypes(runs):
    """Under `mixed` (bf16 parameters and images) the stem conv is the one
    bf16 product: its BatchNorm computes and returns f32, so every later
    conv and the head run in f32 on bf16-valued weights, as flax's dtype
    promotion runs them. flax declares the stem's output bf16 and the port
    rounds it there; XLA's excess precision skips that rounding (BatchNorm
    reads it in f32), which moves the eval logits by 1.2e-3 of their
    largest magnitude here (3.6e-3 in training mode; limit 1e-2; ROADMAP.md,
    Queue C record 3). The port with that one rounding removed reads 1.2e-6
    in training mode."""
    from torch.func import functional_call

    r = runs("resnet18")
    name, cfg, x = CASES["resnet18"]
    bundle = jax_build(name, dict(cfg))
    bf16 = lambda t: jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), t)  # noqa: E731
    want = np.asarray(jax.jit(lambda v: bundle.module.apply(
        {"params": bf16(v["params"]), "batch_stats": v["batch_stats"]},
        jnp.asarray(x, jnp.bfloat16), train=False))(r["variables"]), np.float32)
    module = build_model(name, dict(cfg), device="cpu").module.eval()
    module.load_state_dict(params_from_jax(r["variables"]["params"], None,
                                           r["variables"]["batch_stats"]))
    seen = []
    hooks = [m.register_forward_hook(lambda m, i, o: seen.append((i[0].dtype, o.dtype)))
             for m in module.modules() if isinstance(m, Conv)]
    params = {k: p.detach().to(torch.bfloat16) for k, p in module.named_parameters()}
    with torch.no_grad():
        got = functional_call(module, params, (torch.from_numpy(x).to(torch.bfloat16),))
    for h in hooks:
        h.remove()
    assert seen[0] == (torch.bfloat16, torch.bfloat16)
    assert set(seen[1:]) == {(torch.float32, torch.float32)}
    assert got.dtype == torch.float32
    assert np.abs(got.numpy() - want).max() / np.abs(want).max() < 1e-2
