"""The port's mesh placement on ``torch.distributed``, against the JAX
package and the port's single placement.

One module-scoped fixture starts a gloo world of 2 CPU ranks
(``launch.world.run_world``: spawned processes meeting at a ``FileStore``,
a 60 s group timeout and a bounded join) and runs every scenario in it, on
the data and config of ``tests/test_distributed.py``: ``make_rings(1024,
2)``, R = 128, d_g = 4,096. The reference's RB params and mat-vec operand
are injected. Tolerances: the sharded Gram product within 1e-5 of the
port's single-process product and of the reference's (float32 sums in
another order), bf16 compression within 1e-2 relative; bin counts and
degrees bit for bit; the mesh fit's accuracy ≥ the reference's − 0.01 and
ARI ≥ 0.99 against the port's single fit, the same labels on both ranks;
``predict(mesh=)`` and a partitioned fit on the mesh bit for bit.

The module's top level imports no JAX: the ranks import it by name.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import SCRBConfig, SCRBModel, metrics
from repro_torch.data.synthetic import make_rings

CFG = dict(n_clusters=2, n_grids=128, sigma=0.15, d_g=4096,
           kmeans_replicates=2, seed=0)
N = 1024


def _catch(fn, *args, **kw):
    """The exception type and message of ``fn(*args, **kw)``, or None."""
    try:
        fn(*args, **kw)
    except Exception as e:                    # noqa: BLE001 — reported
        return type(e).__name__, str(e)
    return None


def _scenarios(x, params, u):
    """Every scenario, on each rank of the world; returns this rank's
    results as host arrays."""
    import torch.distributed as dist

    from repro_torch.core import PartitionOptions, SolverOptions, graph
    from repro_torch.core import featuremap as tfm
    from repro_torch.core.distributed import (
        all_gather_rows, make_degree_pass, make_gram_matvec,
        sc_rb_distributed,
    )
    from repro_torch.launch import mesh as lm

    torch.set_num_threads(2)
    out = {"rank": dist.get_rank()}
    mesh = lm.make_host_mesh(device_type="cpu")
    lo, rows = N // 2 * lm.data_rank(mesh), N // 2
    fmap = tfm.RBMap.from_state(*params)
    d, d_g = fmap.n_features, fmap.d_g
    idx = fmap.transform(torch.from_numpy(x[lo:lo + rows]))
    group = lm.data_group(mesh)

    # degree pass and Gram products, whole shards and chunks of 48 rows
    deg, counts = make_degree_pass(mesh, idx, d, d_g)()
    out["counts"] = counts.numpy()
    out["deg"] = all_gather_rows(deg, group).numpy()
    scale = 1.0 / torch.sqrt(128.0 * deg)
    u_local = torch.from_numpy(u[lo:lo + rows])
    for tag, kw in (("gram", {}), ("gram_chunked", {"chunk_size": 48}),
                    ("gram_bf16", {"compress": True})):
        mv = make_gram_matvec(mesh, idx, scale, d, d_g, **kw)
        out[tag] = all_gather_rows(mv(u_local), group).numpy()
    full = graph.build_normalized_adjacency(
        all_gather_rows(idx, group), d=d, d_g=d_g)
    out["gram_single"] = full.gram_matvec(torch.from_numpy(u)).numpy()

    # meshes with a model axis (sizes 1 here) and a pod axis
    for shape, axes in (((2, 1), ("data", "model")),
                        ((1, 2), ("data", "model")),
                        ((2, 1, 1), ("pod", "data", "model"))):
        m = lm.make_mesh(shape, axes, device_type="cpu")
        out[f"mesh{shape}"] = (lm.data_axes(m), lm.data_shards(m),
                               lm.data_rank(m), lm.partition_devices(m),
                               dist.get_world_size(lm.data_group(m)))
    pod = lm.make_mesh((2, 1, 1), ("pod", "data", "model"),
                       device_type="cpu")
    out["gram_pod"] = all_gather_rows(
        make_gram_matvec(pod, idx, scale, d, d_g)(u_local), group).numpy()
    out["production"] = _catch(lm.make_production_mesh)

    # the mesh fit, within-shard chunks of 64 rows, through the model
    cfg = SCRBConfig(**CFG, chunk_size=64)
    model = SCRBModel.fit(x, cfg, mesh=mesh, device="cpu")
    res = model.fit_result
    out["labels"] = res.labels
    out["diag"] = {k: v for k, v in res.diagnostics.items()
                   if k.startswith("kmeans_") or k in (
                       "n_shards", "shard_rows", "solver",
                       "solver_iterations", "plan")}
    out["sig"] = res.singular_values
    out["embedding"] = res.embedding
    out["predict_mesh"] = model.predict(x[:301], mesh=mesh)
    out["predict_mesh_bucketed"] = model.predict(x[:301], batch_size=100,
                                                 mesh=mesh)
    out["predict"] = model.predict(x[:301])
    out["transform_mesh"] = model.transform(x[:64], mesh=mesh)
    out["transform"] = model.transform(x[:64])
    out["right_vectors"] = model.right_vectors.numpy()

    # the entry point on the whole-shard plan (its return values: tol 1e-3
    # is enough for them), and the errors
    labels, timer = sc_rb_distributed(
        x, SCRBConfig(**CFG, solver_options=SolverOptions(tol=1e-3)), mesh,
        device="cpu")
    out["dist_labels"], out["dist_stages"] = labels, sorted(timer.times)
    out["errors"] = {
        "rows": _catch(SCRBModel.fit, x[:1023], SCRBConfig(**CFG),
                       mesh=mesh, device="cpu"),
        "lanczos": _catch(SCRBModel.fit, x, SCRBConfig(
            **CFG, solver_options=SolverOptions(solver="lanczos")),
            mesh=mesh, device="cpu"),
        "compressive": _catch(SCRBModel.fit, x, SCRBConfig(
            **CFG, solver_options=SolverOptions(solver="compressive")),
            mesh=mesh, device="cpu"),
    }
    from repro_torch.core import ExecutionPlan, make_feature_map
    dense = ExecutionPlan(placement="mesh", mesh=mesh,
                          feature_map=make_feature_map("rff", rank=16,
                                                       sigma=0.15))
    out["errors"]["dense"] = _catch(SCRBModel.fit, x, SCRBConfig(**CFG),
                                    plan=dense, device="cpu")

    # a partitioned fit with the mesh: partition i on rank i mod 2
    pcfg = SCRBConfig(**CFG, partition=PartitionOptions(n_partitions=3))
    pres = SCRBModel.fit(x, pcfg, mesh=mesh, device="cpu").fit_result
    out["part_labels"] = pres.labels
    out["part_sig"] = pres.singular_values
    out["part_diag"] = pres.diagnostics["partitioned"]
    return out


@pytest.fixture(scope="module")
def world():
    """The reference's inputs, the port's single-process fits, and the
    ranks' results."""
    import jax
    import jax.numpy as jnp

    from repro.core import SCRBConfig as JConfig
    from repro.core import graph as jgraph
    from repro.core import rb as jrb
    from repro.core import sc_rb as jsc_rb
    from repro.core import featuremap as jfm
    from repro.utils import fold_key
    from repro_torch.launch.world import run_world

    x, y = make_rings(N, 2, seed=0)
    key = jax.random.PRNGKey(0)
    params = jrb.make_rb_params(fold_key(key, "rb"), CFG["n_grids"], 2,
                                CFG["sigma"], CFG["d_g"])
    jmap = jfm.RBMap(n_grids=CFG["n_grids"], sigma=CFG["sigma"],
                     d_g=CFG["d_g"], params=params)
    idx = jrb.rb_transform(jnp.asarray(x), params)
    adj = jgraph.build_normalized_adjacency(idx, d=params.n_features,
                                            d_g=CFG["d_g"])
    u = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (N, 4)),
                   np.float32)
    ranks = run_world(_scenarios, 2, backend="gloo",
                      args=(x, (jmap.meta_dict(), jmap.state_dict()), u),
                      timeout_s=60.0, join_timeout_s=600.0)
    ref = jsc_rb(jnp.asarray(x), JConfig(**CFG))
    single = SCRBModel.fit(x, SCRBConfig(**CFG), device="cpu")
    return dict(x=x, y=y, u=u, want=np.asarray(adj.gram_matvec(u)),
                idx=np.asarray(idx), ranks=ranks,
                ref_acc=metrics.accuracy(ref.labels, y), single=single)


def test_world_of_two_ranks(world):
    assert [r["rank"] for r in world["ranks"]] == [0, 1]


def test_sharded_gram_product(world):
    for r in world["ranks"]:
        np.testing.assert_allclose(r["gram"], world["want"], atol=1e-5)
        np.testing.assert_allclose(r["gram"], r["gram_single"], atol=1e-5)
        np.testing.assert_allclose(r["gram_chunked"], r["gram_single"],
                                   atol=1e-5)
        np.testing.assert_allclose(r["gram_pod"], r["gram"], atol=0)
        rel = np.abs(r["gram_bf16"] - r["gram_single"]).max() \
            / np.abs(r["gram_single"]).max()
        assert rel <= 1e-2, rel


def test_degree_pass_bit_equal_to_the_single_path(world):
    from repro_torch.core import graph, streaming
    idx = torch.from_numpy(np.array(world["idx"]))
    d = CFG["n_grids"] * CFG["d_g"]
    counts = streaming.chunked_bin_counts([idx], d=d, d_g=CFG["d_g"])
    deg = graph.rb_degrees_exact(idx, d=d, d_g=CFG["d_g"])
    for r in world["ranks"]:
        np.testing.assert_array_equal(r["counts"], counts.numpy())
        np.testing.assert_array_equal(r["deg"], deg.numpy())


def test_mesh_shapes_and_groups(world):
    r0, r1 = world["ranks"]
    assert r0["mesh(2, 1)"] == (("data",), 2, 0, (0, 1), 2)
    assert r1["mesh(2, 1)"] == (("data",), 2, 1, (0, 1), 2)
    assert r0["mesh(1, 2)"] == (("data",), 1, 0, (0,), 1)
    assert r1["mesh(1, 2)"] == (("data",), 1, 0, (0,), 1)
    assert r1["mesh(2, 1, 1)"] == (("pod", "data"), 2, 1, (0, 1), 2)
    err = r0["production"]
    assert err and err[0] == "ValueError" and "256 ranks" in err[1]


def test_production_mesh_shape():
    from repro_torch.launch.mesh import production_mesh_shape
    assert production_mesh_shape() == ((16, 16), ("data", "model"))
    assert production_mesh_shape(multi_pod=True) == (
        (2, 16, 16), ("pod", "data", "model"))


def test_mesh_fit_quality_and_agreement(world):
    r0, r1 = world["ranks"]
    np.testing.assert_array_equal(r0["labels"], r1["labels"])
    acc = metrics.accuracy(r0["labels"], world["y"])
    assert acc >= world["ref_acc"] - 0.01, (acc, world["ref_acc"])
    single = world["single"].fit_result
    assert metrics.adjusted_rand_index(r0["labels"], single.labels) >= 0.99
    np.testing.assert_allclose(r0["sig"], single.singular_values, atol=1e-4)
    assert r0["embedding"].shape == (N, 2)
    np.testing.assert_array_equal(r0["embedding"], r1["embedding"])
    np.testing.assert_array_equal(r0["right_vectors"], r1["right_vectors"])


def test_mesh_fit_residency_diagnostics(world):
    diag = world["ranks"][0]["diag"]
    assert diag["plan"]["placement"] == "mesh"
    assert diag["plan"]["residency"] == "host_chunked"
    assert diag["kmeans_chunk_rows"] == 64
    assert diag["kmeans_shard_rows"] == diag["shard_rows"] == N // 2
    assert diag["n_shards"] == 2
    assert diag["kmeans_device_bytes_peak"] < \
        diag["kmeans_single_shard_bytes"]


def test_predict_and_transform_with_a_mesh(world):
    for r in world["ranks"]:
        np.testing.assert_array_equal(r["predict_mesh"], r["predict"])
        np.testing.assert_array_equal(r["predict_mesh_bucketed"],
                                      r["predict"])
        np.testing.assert_array_equal(r["transform_mesh"], r["transform"])


def test_sc_rb_distributed_returns_labels_and_timer(world):
    r0, r1 = world["ranks"]
    np.testing.assert_array_equal(r0["dist_labels"], r1["dist_labels"])
    assert r0["dist_labels"].shape == (N,)
    assert metrics.adjusted_rand_index(r0["dist_labels"],
                                       r0["labels"]) >= 0.99
    assert {"rb_features", "degrees", "svd", "normalize", "kmeans",
            "oos_state"} == set(r0["dist_stages"])


def test_mesh_errors(world):
    errs = world["ranks"][0]["errors"]
    assert errs["rows"][0] == "ValueError" and "divisible" in errs["rows"][1]
    for solver in ("lanczos", "compressive"):
        assert errs[solver][0] == "NotImplementedError"
        assert "ROADMAP.md A8" in errs[solver][1]
    assert errs["dense"][0] == "ValueError" and "ELL" in errs["dense"][1]


def test_partitioned_fit_on_a_mesh_matches_one_process(world):
    from repro_torch.core import PartitionOptions, executor
    pcfg = SCRBConfig(**CFG, partition=PartitionOptions(n_partitions=3))
    alone = executor.execute(world["x"], pcfg, device="cpu")
    for r in world["ranks"]:
        np.testing.assert_array_equal(r["part_labels"], alone.labels)
        np.testing.assert_array_equal(r["part_sig"], alone.singular_values)
        assert r["part_diag"]["partition_rows"] == \
            alone.diagnostics["partitioned"]["partition_rows"]
        assert r["part_diag"]["devices"] == 2


def test_a_mesh_needs_a_process_group():
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh
    assert not dist.is_initialized()
    with pytest.raises((ValueError, RuntimeError)):
        make_host_mesh(device_type="cpu")


# -- the reference's exports the port now has, held against it ------------

def _ell_case():
    rng = np.random.default_rng(3)
    n, r, d_g = 300, 6, 64
    idx = (rng.integers(0, d_g, size=(n, r))
           + np.arange(r)[None, :] * d_g).astype(np.int32)
    return idx, rng.normal(size=(n, 3)).astype(np.float32), \
        rng.uniform(0.1, 1.0, size=n).astype(np.float32), r * d_g, d_g


@pytest.mark.parametrize("chunk", [1, 48, 300, 1000])
def test_chunked_products_match_the_reference(chunk):
    import jax.numpy as jnp

    from repro.core import streaming as jstreaming
    from repro_torch.core import streaming
    idx, u, s, d, d_g = _ell_case()
    want = jstreaming.chunked_gram_matvec(
        jnp.asarray(idx), jnp.asarray(u), jnp.asarray(s), d=d, d_g=d_g,
        chunk_size=chunk, impl="xla")
    got = streaming.chunked_gram_matvec(
        torch.from_numpy(idx), torch.from_numpy(u), torch.from_numpy(s),
        d=d, d_g=d_g, chunk_size=chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    q = streaming.chunked_zt_matmul(
        torch.from_numpy(idx), torch.from_numpy(u), torch.from_numpy(s),
        d=d, d_g=d_g, chunk_size=chunk)
    np.testing.assert_allclose(q.numpy(), np.asarray(
        jstreaming.chunked_zt_matmul(jnp.asarray(idx), jnp.asarray(u),
                                     jnp.asarray(s), d=d, d_g=d_g,
                                     chunk_size=chunk, impl="xla")),
        atol=1e-5)
    y = streaming.chunked_z_matmul(torch.from_numpy(idx), q,
                                   torch.from_numpy(s), d_g=d_g,
                                   chunk_size=chunk)
    whole = streaming.chunked_z_matmul(torch.from_numpy(idx), q,
                                       torch.from_numpy(s), d_g=d_g,
                                       chunk_size=None)
    np.testing.assert_array_equal(y.numpy(), whole.numpy())  # row-local


def test_rb_exports_match_the_reference():
    import jax.numpy as jnp

    from repro.core import graph as jgraph
    from repro.core import rb as jrb
    from repro_torch import core
    from repro_torch.core import graph, rb
    rng = np.random.default_rng(0)
    x = rng.normal(size=(40, 3))
    y = rng.normal(size=(25, 3))
    for name in ("laplacian_kernel", "gaussian_kernel"):
        np.testing.assert_allclose(
            getattr(rb, name)(x, y, sigma=0.7),
            getattr(jrb, name)(x, y, sigma=0.7), rtol=1e-12)
        np.testing.assert_allclose(getattr(rb, name)(x, sigma=0.7),
                                   getattr(jrb, name)(x, sigma=0.7),
                                   rtol=1e-12)
    idx, _, _, d, d_g = _ell_case()
    assert abs(rb.expected_nonempty_bins(torch.from_numpy(idx), d_g)
               - jrb.expected_nonempty_bins(jnp.asarray(idx), d_g)) < 1e-4
    np.testing.assert_allclose(
        graph.rb_degrees(torch.from_numpy(idx), d=d, d_g=d_g).numpy(),
        np.asarray(jgraph.rb_degrees(jnp.asarray(idx), d=d, d_g=d_g,
                                     impl="xla")), rtol=1e-5)
    for name in ("MeshRows", "PartitionedRows", "chunked_gram_matvec",
                 "rb_degrees", "rb_degrees_exact", "laplacian_kernel",
                 "gaussian_kernel", "expected_nonempty_bins"):
        assert hasattr(core, name), name
