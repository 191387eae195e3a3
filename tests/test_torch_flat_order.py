"""The port's flat order is ``repro``'s, on the CPU.

``repro`` flattens a parameter (or gradient) tree in ``jax.tree.leaves``
order: dict keys sorted, each layer stack one ``(L, ...)`` leaf.  The
port keeps layers as a list of dicts; ``_tree.flatten`` walks them
leaf-major so that its flat vector holds the same elements in the same
places.  Every flat layout shared with ``repro`` rests on it: the
gradient-sync buckets, the int8 chunks of ``lane_int8``, the ZeRO shards
and their decay masks.

* for every arch at smoke size, the port's leaves in that order, grouped
  by ``repro``'s path, are ``jax.tree.leaves`` of ``repro``'s tree, leaf
  for leaf and element for element, and ``_flatten_bucket`` /
  ``decay_mask_flat`` equal ``repro``'s;
* a 4-rank gloo ``lane_int8`` (and ``lane``) ``grad_sync`` of
  llama3.2-3b's smoke gradients (``repro``'s, four batches, bridged)
  equals ``repro``'s on a (pod 2 × data 2) mesh: ``lane`` bit for bit,
  ``lane_int8`` to a rounding of the dequantized sum, because its 1024-
  element chunks hold the same elements.
"""
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import resolve as jresolve
from repro.models import init_model as jinit
from repro.models import loss_fn as jloss
from repro.optim import gradsync as jgs
from repro_torch import _tree
from repro_torch.bridge import params_from_repro
from repro_torch.configs import all_archs, resolve
from repro_torch.launch import mesh
from repro_torch.optim import gradsync as tgs

import _torch_dist_workers as workers
from _torch_dist_workers import REPRO_SIDE, ROOT, repro_env, save_tree

ARCHS = all_archs()


@pytest.fixture(scope="module")
def zoo():
    """arch -> (repro's smoke tree as numpy, the port's bridged tree)."""
    made = {}

    def get(arch):
        if arch not in made:
            tree = jax.tree.map(np.asarray, jinit(
                jax.random.PRNGKey(0), jresolve(arch, smoke=True)))
            made[arch] = (tree, params_from_repro(
                tree, resolve(arch, smoke=True), device="cpu"))
        return made[arch]
    return get


@pytest.mark.parametrize("arch", ARCHS)
def test_repro_order_is_jax_tree_leaves(zoo, arch):
    tree, port = zoo(arch)
    want = jax.tree_util.tree_flatten_with_path(tree)[0]
    groups = {}
    for path, leaf in _tree.flatten(port):
        groups.setdefault(_tree.repro_path(path)[0], []).append(
            (path, leaf))
    assert len(groups) == len(want)
    for (rpath, got), (jpath, jleaf) in zip(groups.items(), want):
        assert "/".join(rpath) == "/".join(k.key for k in jpath)
        if _tree.is_stacked(got[0][0]):
            assert [_tree.repro_path(p)[2] for p, _ in got] \
                == list(range(jleaf.shape[0]))
            arr = np.stack([t.numpy() for _, t in got])
        else:
            assert len(got) == 1
            arr = got[0][1].numpy()
        np.testing.assert_array_equal(arr, jleaf)


@pytest.mark.parametrize("arch", ARCHS)
def test_flatten_bucket_and_decay_mask_match_repro(zoo, arch):
    tree, port = zoo(arch)
    jflat, _ = jgs._flatten_bucket(jax.tree.map(jnp.asarray, tree), 7)
    tflat, _ = tgs._flatten_bucket(port, 7)
    np.testing.assert_array_equal(tflat.numpy(), np.asarray(jflat))
    jmask = np.asarray(jgs.decay_mask_flat(tree, 7))
    np.testing.assert_array_equal(tgs.decay_mask_flat(port, 7).numpy(),
                                  jmask)
    np.testing.assert_array_equal(
        tgs.decay_mask_flat(port, 7, dtype=torch.bool).numpy(), jmask > 0)


GRAD_ARCH = "llama3.2-3b"


@pytest.fixture(scope="module")
def synced_tree(tmp_path_factory, zoo):
    """(repro's per-strategy results, the port's by rank) for llama3.2-3b's
    smoke gradients of four batches, one per rank."""
    tmp = tmp_path_factory.mktemp("flat_order")
    tree, _ = zoo(GRAD_ARCH)
    cfg = jresolve(GRAD_ARCH, smoke=True)
    rng = np.random.default_rng(4)
    grads = []
    for _ in range(4):
        toks = rng.integers(0, cfg.vocab_size, size=(2, 16))
        grads.append(jax.grad(lambda p, t=toks: jloss(
            p, cfg, jnp.asarray(t[:, :-1]), jnp.asarray(t[:, 1:])))(
                jax.tree.map(jnp.asarray, tree)))
    stacked = jax.tree.map(lambda *a: np.stack([np.asarray(x) for x in a]),
                           *grads)
    src = tmp / "grads.npz"
    save_tree(src, stacked)
    out = tmp / "repro.npz"
    proc = subprocess.Popen(
        [sys.executable, str(REPRO_SIDE), "gradsync_tree", str(src),
         str(out)], env=repro_env(4), cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    try:
        port = mesh.spawn(workers.gradsync_tree_rank, 4, str(src),
                          GRAD_ARCH)
        log, _ = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, log[-4000:]
    with np.load(out) as z:
        want = {k: z[k] for k in z.files}
    return want, port


def test_model_tree_grad_sync_lane_matches_repro(synced_tree):
    want, port = synced_tree
    keys = [k for k in want if k.startswith("lane/")]
    assert len(keys) > 5
    for key in keys:
        for r in range(4):
            np.testing.assert_array_equal(port[r][key], want[key][r],
                                          err_msg=key)


def test_model_tree_grad_sync_int8_matches_repro(synced_tree):
    """The quantized values are ``repro``'s; the dequantized lane sum
    may round once differently (XLA fuses the multiply-add), so within
    1e-6 of the leaf's largest value — a chunk with other elements in it
    would be off by up to half a quantization step, ~4e-3 of its
    largest."""
    want, port = synced_tree
    keys = [k for k in want if k.startswith("lane_int8/")]
    assert len(keys) > 5
    for key in keys:
        for r in range(4):
            w = want[key][r]
            np.testing.assert_allclose(port[r][key], w, rtol=1e-6,
                                       atol=1e-6 * np.abs(w).max(),
                                       err_msg=key)
