"""The port's ``lm_loss`` and its gradients against the JAX package's for
the mixers and FFNs beyond internlm2's (``test_torch_train.py``): MLA with
the MoE FFN and its aux loss (deepseek-v2-lite-16b), the SSM mixer with
no FFN (mamba2-370m), the hybrid mixer with a sliding window (hymba-1.5b)
and embeds input with QKV bias (qwen2-vl-7b), on the CPU at smoke size in
float32.

Parameters in the JAX package's tree layout (checked against its
``init_params`` by ``jax.eval_shape``) are carried across with
``transformer.params_from_reference(masters=True)``; the
batch (2 × 64 positions, a few labels masked) comes from numpy with a
seed. Tolerances: the loss and every gradient leaf within 1e-4 relative
L2 (float32 through two layers in another summation order; measured ≤
3.1e-6); the three remat settings within 1e-6 of one another (the same
operations, recomputed). The JAX reference's value-and-grad runs once per
architecture under ``jax.jit``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch_threads  # noqa: F401  (one thread under xdist)

from repro.configs import smoke_config as jsmoke_config
from repro.models import transformer as JT
from repro_torch import configs
from repro_torch.models import transformer as T
from repro_torch.train import checkpoint as ckpt

ARCHS = ("deepseek-v2-lite-16b", "mamba2-370m", "hymba-1.5b", "qwen2-vl-7b")
GRAD_TOL = 1e-4


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _tree(cfg, seed):
    """Parameters in the JAX package's tree layout (numpy), drawn by the
    port (the JAX package's eager ``init_params`` takes up to 11 s at
    smoke size; either package's draws will do)."""
    return T.params_to_reference(cfg, T.init_params(cfg, seed, device="cpu",
                                                    masters=True))


def _batch(cfg, b=2, s=64):
    rng = np.random.default_rng(1)
    labels = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    labels[1, -4:] = -1                      # masked positions
    if cfg.input_mode == "embeds":
        return {"embeds": rng.normal(size=(b, s, cfg.d_model)).astype(
            np.float32), "labels": labels}
    return {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(
        np.int32), "labels": labels}


@pytest.fixture(scope="module", params=ARCHS)
def reference(request):
    arch = request.param
    jcfg = jsmoke_config(arch)
    cfg = configs.smoke_config(arch)
    tree = _tree(cfg, 0)
    batch = _batch(cfg)
    fn = jax.jit(jax.value_and_grad(
        lambda p, b: JT.lm_loss(jcfg, p, b), has_aux=True))
    (loss, metrics), grads = fn(tree, {k: jnp.asarray(v)
                                       for k, v in batch.items()})
    return {"arch": arch, "cfg": cfg, "tree": tree, "batch": batch,
            "loss": float(loss),
            "metrics": {k: float(v) for k, v in metrics.items()},
            "grads": jax.tree_util.tree_map(np.asarray, grads)}


def _port(cfg, tree, batch):
    model = T.params_from_reference(cfg, tree, device="cpu", masters=True)
    loss, metrics = T.lm_loss(cfg, model, batch)
    loss.backward()
    grads = T.params_to_reference(
        cfg, {n: p.grad for n, p in model.named_parameters()})
    return (float(loss.detach()),
            {k: float(v.detach()) for k, v in metrics.items()}, grads)


def test_lm_loss_and_every_gradient_match_reference(reference):
    loss, metrics, grads = _port(reference["cfg"], reference["tree"],
                                 reference["batch"])
    assert loss == pytest.approx(reference["loss"], rel=GRAD_TOL)
    for k in ("ce", "aux"):
        assert metrics[k] == pytest.approx(reference["metrics"][k],
                                           rel=GRAD_TOL, abs=1e-9)
    assert metrics["tokens"] == reference["metrics"]["tokens"] == 124
    if reference["arch"] == "deepseek-v2-lite-16b":
        assert metrics["aux"] > 0            # the MoE's load-balance term
    flat = jax.tree_util.tree_flatten_with_path(reference["grads"])[0]
    mine = ckpt.tree_leaves(grads)
    assert len(mine) == len(flat)
    for (path, want), got in zip(flat, mine):
        assert float(np.abs(want).max()) > 0, jax.tree_util.keystr(path)
        assert _rel(got, want) < GRAD_TOL, jax.tree_util.keystr(path)


def test_params_round_trip_through_the_reference_tree(reference):
    """The tree has the JAX ``init_params``'s structure and shapes, and
    goes through the port's modules bit for bit."""
    cfg, tree = reference["cfg"], reference["tree"]
    shapes = jax.eval_shape(lambda: JT.init_params(
        jsmoke_config(reference["arch"]), jax.random.PRNGKey(0)))
    assert jax.tree_util.tree_structure(shapes) == \
        jax.tree_util.tree_structure(tree)
    assert [a.shape for a in jax.tree_util.tree_leaves(shapes)] == \
        [a.shape for a in jax.tree_util.tree_leaves(tree)]
    back = T.params_to_reference(cfg, T.params_from_reference(
        cfg, tree, device="cpu", masters=True))
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(tree)
    for a, b in zip(ckpt.tree_leaves(back), jax.tree_util.tree_leaves(tree)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_remat_settings_give_equal_loss_and_gradients(reference):
    out = {}
    for remat in ("none", "dots", "full"):
        cfg = dataclasses.replace(reference["cfg"], remat=remat)
        out[remat] = _port(cfg, reference["tree"], reference["batch"])
    for remat in ("dots", "full"):
        assert out[remat][0] == pytest.approx(out["none"][0], rel=1e-6)
        for a, b in zip(ckpt.tree_leaves(out[remat][2]),
                        ckpt.tree_leaves(out["none"][2])):
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-9)


def test_mrope_positions_train():
    """qwen2-vl-7b's M-RoPE positions (3, B, S) go through the training
    forward as through the reference's."""
    arch = "qwen2-vl-7b"
    cfg, jcfg = configs.smoke_config(arch), jsmoke_config(arch)
    tree = _tree(cfg, 2)
    pos = np.broadcast_to(np.arange(64)[None, None], (3, 2, 64)).copy()
    pos[1:, :, 32:] += np.arange(32) % 5      # h, w streams part ways
    batch = dict(_batch(cfg), positions=pos.astype(np.int32))
    fn = jax.jit(lambda p, b: JT.lm_loss(jcfg, p, b)[0])
    want = fn(tree, {k: jnp.asarray(v) for k, v in batch.items()})
    model = T.params_from_reference(cfg, tree, device="cpu", masters=True)
    got, _ = T.lm_loss(cfg, model, batch)
    assert float(got) == pytest.approx(float(want), rel=GRAD_TOL)
