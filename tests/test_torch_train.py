"""The port's training path against ``repro``'s, on the CPU at smoke size.

``loss_fn`` and its gradient for every family, the replicated train step
(one and three AdamW steps), microbatched accumulation, remat, and the
single-process training loop ``repro_torch.launch.train``.  Both packages start
from ``repro.models.init_model``'s weights through ``repro_torch.bridge``;
tokens, labels (with -100) and extras are numpy draws from a seed.  On the
CPU the kernels' plain versions run, and the port differentiates them with
autograd; ``repro`` takes ``jax.value_and_grad`` of its own ``loss_fn``.

Tolerances, in f32:
  * loss: 1e-5 relative; the frameworks' f32 reduction order differs;
  * a gradient, parameter or moment leaf: 1e-4 of the leaf's largest
    magnitude (GRAD_TOL), the same rounding carried through the backward
    of a few layers, plus 1e-9 for leaves whose gradient is zero but for
    rounding (a key bias shifts each query's scores alike: ~1e-12);
  * after AdamW steps, the steps taken agree within 1e-3 of lr at all but
    1% of each leaf's elements, and within 1e-2 of lr at every element
    whose gradient at every step is above 1e-6 of its leaf's largest and,
    once clipped, above 10 x AdamW's eps.  AdamW's step is a normalised
    gradient, m / (sqrt(v) + eps): it passes each element's relative
    rounding on whole, and that is large for small elements (a gradient
    of 1e-7 may carry 1e-2), for those near eps, for those of noise
    level, whose sign may differ, and where steps of opposite sign cancel
    in m.  After three steps the gradients come from parameters that are
    that far apart already, so m and v are held at 1e-3 of their leaf's
    largest (measured: 1.8e-4).
  * microbatch accumulation in bf16: 1e-2 of the leaf's largest (the f32
    gradients rounded to bf16 may round apart by one bf16 ulp).
"""
import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from repro.configs import RunConfig as JRunConfig
from repro.configs import resolve as jresolve
from repro.configs.base import ShapeConfig
from repro.launch.steps import _accum_dtype as j_accum_dtype
from repro.launch.steps import _microbatched as j_microbatched
from repro.models import init_model as jinit
from repro.models import loss_fn as jloss_fn
from repro.optim import adamw as jadamw
from repro_torch import _tree
from repro_torch.bridge import params_from_repro, params_to_repro
from repro_torch.checkpoint import committed_steps
from repro_torch.configs import RunConfig, resolve
from repro_torch.launch import train
from repro_torch.launch.steps import build_train_step, init_train_state
from repro_torch.models import loss_fn, model_forward
from repro_torch.optim import AdamWConfig
from torch.utils._python_dispatch import TorchDispatchMode

LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
ATOL = 1e-9            # a leaf whose gradient is 0 analytically (a K bias)
BF16_ACCUM_TOL = 1e-2
NOISE = 1e-6           # a gradient below NOISE x max|g| may flip sign
EPS_FACTOR = 10        # AdamW's update is sensitive where |g| ~ its eps
UPDATE_TOL = 1e-3      # of lr: the steps taken by the two AdamWs...
UPDATE_MAX = 1e-2      # ...and the most any robust element's may differ
LATER_MOMENT_TOL = 1e-3  # m, v after steps taken from parameters apart
FLIP_SHARE = 1e-2      # at most this share of a leaf's elements disagree
FAMILIES = ["llama3.2-3b", "mamba2-780m", "zamba2-7b",
            "granite-moe-3b-a800m", "llava-next-mistral-7b",
            "whisper-large-v3"]
B, T = 2, 12
_jupdate = jax.jit(jadamw.adamw_update, static_argnums=0)


@pytest.fixture(scope="module")
def zoo():
    """``get(arch) -> (repro config, port config, repro's init as numpy,
    jitted value_and_grad of repro's loss_fn(params, tokens, labels,
    extra))``, each arch made once for the module."""
    made = {}

    def get(arch):
        if arch not in made:
            jc, tc = jresolve(arch, smoke=True), resolve(arch, smoke=True)
            tree = jax.tree.map(np.asarray, jax.jit(jinit, static_argnums=1)(
                jax.random.PRNGKey(0), jc))
            jvg = jax.jit(jax.value_and_grad(
                lambda p, t, l, e: jloss_fn(p, jc, t, l, extra_embeds=e)))
            made[arch] = jc, tc, tree, jvg
        return made[arch]
    return get


def _batch(cfg, seed, b=B):
    """numpy tokens, labels (next tokens, a few set to -100) and the
    family's extra embeddings (or None)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(1, cfg.vocab_size, (b, T + 1)).astype(np.int32)
    labels = toks[:, 1:].copy()
    labels[0, :3] = -100
    labels[-1, -1] = -100
    n = {"vlm": cfg.vision_tokens, "audio": cfg.encoder_seq}.get(cfg.family)
    extra = None if n is None else \
        (rng.normal(size=(b, n, cfg.d_model)) * 0.02).astype(np.float32)
    return toks[:, :-1].copy(), labels, extra


def _torch_batch(toks, labels, extra):
    return (torch.tensor(toks, dtype=torch.long), torch.tensor(labels),
            None if extra is None else torch.tensor(extra))


def _jax_batch(toks, labels, extra):
    return (jnp.asarray(toks), jnp.asarray(labels),
            None if extra is None else jnp.asarray(extra))


def _leaf_close(got, want, tol, name=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    assert np.isfinite(got).all(), name
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= tol * scale + ATOL, \
        f"{name}: max err {err} > {tol} x {scale} + {ATOL}"


def _flat(tree):
    return {"/".join(map(str, p)): np.asarray(v, np.float32)
            for p, v in _tree.flatten(jax.tree.map(np.asarray, tree))}


def _trees_close(mine, theirs, cfg, tol):
    got, want = _flat(params_to_repro(mine, cfg)), _flat(theirs)
    assert set(got) == set(want)
    for k in want:
        _leaf_close(got[k], want[k], tol, k)


# ---------------------------------------------------------------------------
# loss and gradient, every family
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_and_grads_match_repro(zoo, arch):
    _, tc, tree, jvg = zoo(arch)
    toks, labels, extra = _batch(tc, seed=len(arch))
    jl, jg = jvg(tree, *_jax_batch(toks, labels, extra))
    params, _ = init_train_state(params_from_repro(tree, tc, device="cpu"),
                                 device="cpu")
    ttok, tlab, tex = _torch_batch(toks, labels, extra)
    loss = loss_fn(params, tc, ttok, tlab, extra_embeds=tex)
    grads = torch.autograd.grad(loss, _tree.leaves(params),
                                allow_unused=True, materialize_grads=True)
    assert loss.dtype == torch.float32 and loss.ndim == 0
    assert abs(float(loss.detach()) - float(jl)) <= LOSS_TOL * abs(float(jl))
    _trees_close(_tree.unflatten(params, grads), jg, tc, GRAD_TOL)


def test_masked_labels_and_vlm_prefix(zoo):
    """Every label masked gives 0 (the mean's denominator is clamped to
    1); the vlm loss is over the text positions only: its logits' prefix
    is cut off, so moving the patches changes the loss through attention
    alone, and the number of loss positions is the text length."""
    _, tc, tree, _ = zoo("llava-next-mistral-7b")
    params = params_from_repro(tree, tc, device="cpu")
    toks, labels, extra = _torch_batch(*_batch(tc, seed=1))
    masked = torch.full_like(labels, -100)
    assert float(loss_fn(params, tc, toks, masked,
                         extra_embeds=extra)) == 0.0
    logits, _ = model_forward(params, tc, toks, extra_embeds=extra)
    assert logits.shape[1] == tc.vision_tokens + T
    text = logits[:, tc.vision_tokens:].float()
    want = torch.nn.functional.cross_entropy(
        text.reshape(-1, tc.vocab_size), labels.reshape(-1).long(),
        ignore_index=-100)
    assert abs(float(loss_fn(params, tc, toks, labels, extra_embeds=extra))
               - float(want)) <= LOSS_TOL * float(want)


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

def _sensitive(grads, eps) -> dict:
    """Per leaf, the elements whose AdamW update rounding may move far:
    a gradient below NOISE of the leaf's largest (its sign is noise), or
    one whose clipped value is below EPS_FACTOR x eps (the update
    g / (|g| + eps) then turns a relative error of g into one of the
    update)."""
    gs = _flat(grads)
    clip = min(1.0, 1.0 / float(np.sqrt(sum(
        (g.astype(np.float64) ** 2).sum() for g in gs.values()))))
    return {k: (np.abs(g) <= NOISE * np.abs(g).max())
            | (np.abs(g) * clip <= EPS_FACTOR * eps) for k, g in gs.items()}


def _update_close(got, want, before, skip, lr, name):
    """Parameters after AdamW: the steps taken agree within UPDATE_TOL of
    lr but for a FLIP_SHARE of the elements, and within UPDATE_MAX of lr
    at every element that is not ``skip`` (``_sensitive`` at some
    step)."""
    got, want, before = (np.asarray(a, np.float64)
                         for a in (got, want, before))
    err = np.abs((got - before) - (want - before))
    assert (err > UPDATE_TOL * lr).mean() <= FLIP_SHARE, \
        f"{name}: {(err > UPDATE_TOL * lr).sum()} of {err.size} disagree"
    worst = float(err[~skip].max(initial=0.0))
    assert worst <= UPDATE_MAX * lr, f"{name}: update err {worst} vs lr {lr}"


@pytest.mark.parametrize("steps", [1, 3])
@pytest.mark.parametrize("arch", ["llama3.2-3b", "mamba2-780m"])
def test_train_steps_match_repro(zoo, arch, steps):
    """The port's replicated step against ``repro``'s value_and_grad of
    ``loss_fn`` then ``adamw_update``: each step's loss, and the
    parameters, m, v and count after the last."""
    _, tc, tree, jvg = zoo(arch)
    opt = AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=steps)
    jopt = jadamw.AdamWConfig(**dataclasses.asdict(opt))
    step = build_train_step(RunConfig(model=tc), opt)
    params, state = init_train_state(
        params_from_repro(tree, tc, device="cpu"), device="cpu")
    jparams = jax.tree.map(jnp.asarray, tree)
    jstate = jadamw.adamw_init(jparams)
    skip = None
    for s in range(steps):
        toks, labels, _ = _batch(tc, seed=100 + s)
        jl, jg = jvg(jparams, *_jax_batch(toks, labels, None))
        sens = _sensitive(jg, opt.eps)
        skip = sens if skip is None else {k: skip[k] | sens[k] for k in skip}
        jparams, jstate = _jupdate(jopt, jg, jstate, jparams)
        loss, params, state = step(params, state,
                                   *_torch_batch(toks, labels, None)[:2])
        assert abs(float(loss) - float(jl)) <= LOSS_TOL * abs(float(jl))
    assert state["count"] == int(jstate["count"]) == steps
    got, want, before = (_flat(params_to_repro(params, tc)), _flat(jparams),
                         _flat(tree))
    for k in want:
        _update_close(got[k], want[k], before[k], skip[k], opt.lr, k)
    for mine, theirs in ((state["m"], jstate["m"]),
                         (state["v"], jstate["v"])):
        _trees_close(mine, theirs, tc,
                     GRAD_TOL if steps == 1 else LATER_MOMENT_TOL)


def test_step_matches_repros_registered_replicated_step(zoo):
    """``repro``'s own replicated ``train_step`` (the ``native`` flavor,
    through ``build_train_step_lane`` on a one-device mesh, as its
    ``launch.train`` runs it) against the port's step, one step."""
    from jax.sharding import PartitionSpec as P
    from repro.launch.steps import (build_train_step_lane,
                                    init_lane_train_state)
    from repro.launch.mesh import batch_axes
    jc, tc, tree, jvg = zoo("llama3.2-3b")
    opt = AdamWConfig(lr=1e-2, warmup_steps=0, total_steps=4)
    jopt = jadamw.AdamWConfig(**dataclasses.asdict(opt))
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    jrun = JRunConfig(model=jc, shape=ShapeConfig("t", T, B, "train"))
    jstep, comm = build_train_step_lane(jc, jrun, jopt, mesh, None)
    st = init_lane_train_state(jc, jrun, mesh, jax.tree.map(jnp.asarray,
                                                            tree), comm=comm)
    dspec = P(batch_axes(mesh))
    fn = jax.jit(jax.shard_map(
        jstep, mesh=mesh, in_specs=(st.pspecs, st.ospecs, dspec, dspec,
                                    None),
        out_specs=(P(), st.pspecs, st.ospecs), check_vma=False))
    toks, labels, _ = _batch(tc, seed=5)
    jl, jparams, jstate = fn(st.params, st.opt_state, jnp.asarray(toks),
                             jnp.asarray(labels), None)
    params, state = init_train_state(
        params_from_repro(tree, tc, device="cpu"), device="cpu")
    loss, params, state = build_train_step(RunConfig(model=tc), opt)(
        params, state, *_torch_batch(toks, labels, None)[:2])
    assert abs(float(loss) - float(jl)) <= LOSS_TOL * abs(float(jl))
    _, jg = jvg(tree, *_jax_batch(toks, labels, None))
    got, want, before = (_flat(params_to_repro(params, tc)), _flat(jparams),
                         _flat(tree))
    skip = _sensitive(jg, opt.eps)
    for k in want:
        _update_close(got[k], want[k], before[k], skip[k], opt.lr, k)


@pytest.mark.parametrize("accum", ["float32", "bfloat16"])
def test_microbatched_matches_repro(zoo, accum):
    """``microbatch=2``: the loss is the mean of the halves' losses and
    the gradient their mean, accumulated in ``accum`` (``repro``'s
    ``_microbatched`` over its ``value_and_grad``)."""
    jc, tc, tree, _ = zoo("llama3.2-3b")
    toks, labels, _ = _batch(tc, seed=9, b=4)
    jrun = JRunConfig(model=jc, shape=ShapeConfig("t", T, 4, "train"),
                      microbatch=2, accum_dtype=accum)
    jvg = j_microbatched(
        lambda p, t, l, e: jax.value_and_grad(
            lambda q: jloss_fn(q, jc, t, l))(p),
        jrun.microbatch, j_accum_dtype(jrun))
    jl, jg = jax.jit(lambda p, t, l: jvg(p, t, l, None))(
        tree, jnp.asarray(toks), jnp.asarray(labels))
    # the port's step, with AdamW swapped for a recorder of its gradients
    from repro_torch.launch import steps
    run = RunConfig(model=tc, microbatch=2, accum_dtype=accum)
    vg = steps._microbatched(steps._value_and_grad(steps._make_loss(run)),
                             run.microbatch, steps._accum_dtype(run))
    params, _ = init_train_state(params_from_repro(tree, tc, device="cpu"),
                                 device="cpu")
    loss, grads = vg(params, *_torch_batch(toks, labels, None)[:2], None)
    want_dtype = torch.bfloat16 if accum == "bfloat16" else torch.float32
    assert all(g.dtype == want_dtype for g in _tree.leaves(grads))
    assert abs(float(loss) - float(jl)) <= LOSS_TOL * abs(float(jl))
    _trees_close(grads, jg, tc,
                 GRAD_TOL if accum == "float32" else BF16_ACCUM_TOL)


@pytest.mark.parametrize("arch", ["llama3.2-3b", "zamba2-7b",
                                  "whisper-large-v3"])
def test_remat_full_equals_none(zoo, arch):
    """Recomputing every layer in the backward (the encoder's and the
    hybrid's shared block too) gives the same loss and gradient."""
    _, tc, tree, _ = zoo(arch)
    batch = _torch_batch(*_batch(tc, seed=2))
    out = []
    for remat in ("none", "full"):
        params, _ = init_train_state(
            params_from_repro(tree, tc, device="cpu"), device="cpu")
        loss = loss_fn(params, tc, batch[0], batch[1], extra_embeds=batch[2],
                       remat=remat)
        out.append((loss, torch.autograd.grad(loss, _tree.leaves(params))))
    (l0, g0), (l1, g1) = out
    assert torch.equal(l0, l1)
    for a, b in zip(g0, g1):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("arch", ["llama3.2-3b", "mamba2-780m",
                                  "granite-moe-3b-a800m"])
def test_remat_dots_equals_none_and_repro(zoo, arch):
    """``remat="dots"`` (the products with no batch dimensions saved, the
    rest recomputed) gives none's loss and every gradient within 1e-6, and
    ``repro``'s ``remat="dots"`` loss within 1e-6; it recomputes less
    than ``"full"`` does (fewer matmuls in the backward)."""
    jc, tc, tree, _ = zoo(arch)
    toks, labels, extra = _batch(tc, seed=5)
    jl = jax.jit(lambda p, t, l: jloss_fn(p, jc, t, l, remat="dots"))(
        tree, *_jax_batch(toks, labels, extra)[:2])
    batch = _torch_batch(toks, labels, extra)
    out, mms = {}, {}
    for remat in ("none", "dots", "full"):
        params, _ = init_train_state(
            params_from_repro(tree, tc, device="cpu"), device="cpu")
        loss = loss_fn(params, tc, batch[0], batch[1], remat=remat)
        with _CountMM() as count:
            grads = torch.autograd.grad(loss, _tree.leaves(params),
                                        allow_unused=True,
                                        materialize_grads=True)
        out[remat], mms[remat] = (float(loss.detach()), grads), count.n
    (l0, g0), (l1, g1) = out["none"], out["dots"]
    assert abs(l1 - l0) <= 1e-6 * abs(l0)
    assert abs(l1 - float(jl)) <= 1e-6 * abs(float(jl))
    for a, b in zip(g0, g1):
        torch.testing.assert_close(b, a, rtol=1e-6, atol=1e-9)
    assert mms["none"] == mms["dots"] < mms["full"], mms


class _CountMM(TorchDispatchMode):
    """Counts ``aten.mm`` / ``aten.addmm`` calls while it is on."""
    n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
            self.n += 1
        return func(*args, **(kwargs or {}))


def test_remat_dots_and_gradsync_name_their_items(zoo):
    _, tc, tree, _ = zoo("llama3.2-3b")
    params = params_from_repro(tree, tc, device="cpu")
    toks, labels, _ = _torch_batch(*_batch(tc, seed=0))
    assert torch.isfinite(loss_fn(params, tc, toks, labels, remat="dots"))
    with pytest.raises(ValueError, match="remat"):
        RunConfig(model=tc, remat="some")
    with pytest.raises(ValueError, match="accum_dtype"):
        RunConfig(model=tc, accum_dtype="float16")
    assert RunConfig(model=tc, gradsync="auto").gradsync == "auto"
    assert RunConfig(model=tc, gradsync="lane_quorum",
                     remat="dots").gradsync == "lane_quorum"
    for strategy in ("lane_zero1", "lane_zero3"):
        assert RunConfig(model=tc, gradsync=strategy, fsdp_prefetch=-1,
                         fsdp_regather=True).gradsync == strategy
    with pytest.raises(ValueError, match="unknown gradsync"):
        RunConfig(model=tc, gradsync="lane_zero9")
    for strategy in ("native", "lane", "lane_pipelined", "lane_int8"):
        assert RunConfig(model=tc, gradsync=strategy,
                         gradsync_buckets=4).gradsync == strategy


# ---------------------------------------------------------------------------
# the training loop (launch.train.main)
# ---------------------------------------------------------------------------

def test_train_main_on_cpu_loss_falls(capsys):
    losses = train.main(["--arch", "llama3.2-3b", "--smoke", "--steps", "6",
                         "--batch", "4", "--seq", "32", "--log-every", "2",
                         "--device", "cpu"])
    assert len(losses) == 6 and all(np.isfinite(losses))
    assert losses[-1] < losses[0]
    out = capsys.readouterr().out
    assert "step     0  loss" in out and out.rstrip().endswith("OK")


def test_train_main_microbatch_and_remat_on_cpu():
    a = train.main(["--arch", "mamba2-780m", "--smoke", "--steps", "2",
                    "--batch", "4", "--seq", "16", "--device", "cpu"])
    b = train.main(["--arch", "mamba2-780m", "--smoke", "--steps", "2",
                    "--batch", "4", "--seq", "16", "--device", "cpu",
                    "--microbatch", "2", "--remat", "full"])
    np.testing.assert_allclose(a, b, rtol=1e-5)


@pytest.mark.parametrize("flags", [
    ["--model-parallel", "2"],          # one process: no model axis of 2
    ["--expert-parallel"],              # llama has no experts
    ["--ep-blocks", "0"],
])
def test_train_main_unported_flags_raise(flags):
    """The third axis's flags are ported: on one process these raise
    ``repro``'s training loop's errors (the mesh rule, ``RunConfig``'s
    validation)."""
    import repro.launch.train as jtrain
    argv = ["--arch", "llama3.2-3b", "--smoke", "--steps", "1", "--batch",
            "2", "--seq", "8", *flags]
    with pytest.raises(ValueError) as want:
        jtrain.main(argv)
    with pytest.raises(ValueError) as got:
        train.main([*argv, "--device", "cpu"])
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("flags", [
    ["--gradsync", "auto"],
    ["--tuning-cache", "{tmp}"],
    ["--tune", "--tuning-cache", "{tmp}"],
], ids=lambda f: " ".join(a for a in f if a != "{tmp}"))
def test_train_main_tuning_flags_act(flags, tmp_path):
    """The tuning flags on one process, where no gradient sync runs:
    ``--gradsync auto`` and a cache leave the plain step's losses as they
    are, and ``--tune``, with no world's collectives to time, raises.
    (Across ranks: tests/test_torch_tuning_dist.py.)"""
    argv = ["--arch", "llama3.2-3b", "--smoke", "--steps", "2", "--batch",
            "2", "--seq", "8", "--device", "cpu"]
    flags = [a.format(tmp=tmp_path / "c.json") for a in flags]
    if "--tune" in flags:
        with pytest.raises(ValueError, match="started world"):
            train.main(argv + flags)
        assert not (tmp_path / "c.json").exists()
    else:
        assert train.main(argv + flags) == train.main(argv)


RUNTIME = ["--arch", "llama3.2-3b", "--smoke", "--steps", "3", "--batch",
           "2", "--seq", "32", "--log-every", "1", "--device", "cpu"]


@pytest.mark.parametrize("flags", [
    ["--ckpt", "{tmp}", "--fault-plan", "seed:1"],
    ["--fault-plan", "seed:1"],
    ["--lose-chips", "1"],
    ["--quorum-staleness", "3"],
    ["--max-restarts", "0"],
    ["--gradsync", "lane_quorum"],
    ["--remat", "dots"],
], ids=lambda f: " ".join(a for a in f if a != "{tmp}"))
def test_train_main_runtime_flags_act(flags, tmp_path, capsys):
    """The runtime's flags and the cells they raised for before, run on
    one process as ``repro`` runs them on one device.  (Across ranks:
    tests/test_torch_faults_driver.py.)"""
    from repro.runtime import FaultPlan as JFaultPlan
    plain = train.main(RUNTIME)
    capsys.readouterr()
    flags = [a.format(tmp=tmp_path / "ck") for a in flags]
    if flags[-1] == "seed:1":
        # a seeded plan, repro's draw; seed 1 over 3 steps fails the
        # step-2 save twice, which the retry absorbs
        every = ["--ckpt-every", "2"] if "--ckpt" in flags else []
        got = train.main(RUNTIME + flags + every)
        out, err = capsys.readouterr()
        want = JFaultPlan.generate(1, 3, 1)
        assert [dataclasses.astuple(f) for f in want.faults] == \
            [("ckpt_io", 2, 2, 0, 2, 0)]
        assert f"fault plan (seeded): {want.faults}" in out
        assert got == plain
        if "--ckpt" in flags:
            assert "attempt 2/3 failed" in err
            assert committed_steps(str(tmp_path / "ck")) == [2, 3]
    elif flags[0] == "--lose-chips":
        # every loss empties the one-device mesh, as in repro
        with pytest.raises(ValueError, match="all slices of the outer "
                                             "batch axis lost"):
            train.main(RUNTIME + flags)
    elif flags[0] == "--quorum-staleness":
        # one pod masked for three steps: K = 3 keeps degrading (each
        # step's loss exactly 0), the default K = 2 restarts at step 2
        # and finds no pod left
        argv = RUNTIME + ["--gradsync", "lane_quorum", "--fault-plan",
                          "pod_slow@0-2:pod=0"]
        assert train.main(argv + flags) == [0.0, 0.0, 0.0]
        assert "degraded step 2: pod 0 masked; rows [0, 2)" in \
            capsys.readouterr().out
        with pytest.raises(ValueError, match="all slices"):
            train.main(argv)
    elif flags[0] == "--max-restarts":
        # no quorum path: the lost pod restarts at once, and no restart
        # is allowed
        argv = RUNTIME + ["--fault-plan", "pod_lost@1:pod=0"]
        with pytest.raises(RuntimeError, match="giving up after 0 "
                                               "restarts"):
            train.main(argv + flags)
        out, err = capsys.readouterr()
        assert "HEALTHY -> RESTART" in out
        assert "giving up after 0 restarts" in err
        with pytest.raises(ValueError, match="all slices"):
            train.main(argv)
    elif flags[0] == "--gradsync":
        # the full quorum on one device is the plain step, bit for bit
        assert train.main(RUNTIME + flags) == plain
    else:
        np.testing.assert_allclose(train.main(RUNTIME + flags), plain,
                                   rtol=1e-6)


ONE = ["--arch", "llama3.2-3b", "--smoke", "--steps", "2", "--batch", "2",
       "--seq", "8", "--device", "cpu"]


@pytest.mark.parametrize("flags", [
    ["--gradsync", "lane_zero1"],
    ["--gradsync", "lane_zero3"],
    ["--fsdp-prefetch", "2"],
    ["--fsdp-regather"],
])
def test_train_main_zero_flags_accepted(flags):
    """The ZeRO flags are honoured as ``repro`` honours them on one
    process (a single batch axis): ``lane_zero1`` is the replicated
    step, ``lane_zero3`` refuses with ``repro``'s message, and the
    prefetch flags change nothing outside ``lane_zero3``.  (Across ranks:
    tests/test_torch_train_zero.py.)"""
    if flags == ["--gradsync", "lane_zero3"]:
        with pytest.raises(ValueError, match="distinct lane and node"):
            train.main(ONE + flags)
        return
    assert train.main(ONE + flags) == train.main(ONE)


def test_train_main_pods_in_one_process_raises_repros_error():
    """A world of one process has one device: ``repro``'s
    ``make_mesh_auto`` message."""
    with pytest.raises(ValueError,
                       match="1 devices not divisible into 2 pods"):
        train.main(["--arch", "llama3.2-3b", "--smoke", "--steps", "1",
                    "--batch", "2", "--seq", "8", "--device", "cpu",
                    "--pods", "2"])
