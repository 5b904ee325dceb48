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

Every solver under the mesh, in the same world: the reference's scenario
of ``tests/test_executor.py`` (``make_rings(512, 2)``, R = 64, d_g =
1,024, tol 1e-3, 60 iterations; compressive at filter degree 32) for
``subspace``, ``lanczos``, ``compressive``, ``randomized`` and ``auto``
(routed to the compressive cell by ``compressive_auto_n=256``), on the
reference's RB grids and start block (the compressive cell also on its
probe, signal, subset and seed draws): ARI ≥ 0.97 against the reference's
single fit of the same solver (the reference's own bar; ``auto``, on the
port's draws, against the port's), Ritz values within 1e-3 of the port's
single fit, the same iteration count on both ranks; and the n < 3k dense
fallback (4 rows, K = 2) within 1e-5 of the port's single fit. A second
world, of 4 CPU ranks, runs LOBPCG and the randomized sketch on the same
512 rows against the world of 2. The solver fits run at one thread a
process: the ranks share the host's cores with each other.

The module's top level imports no JAX: the ranks import it by name.
"""
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one thread under xdist)

from repro_torch.core import SCRBConfig, SCRBModel, metrics
from repro_torch.data.synthetic import make_rings

CFG = dict(n_clusters=2, n_grids=128, sigma=0.15, d_g=4096,
           kmeans_replicates=2, seed=0)
N = 1024

# the reference's mesh-solver scenario (tests/test_executor.py)
SOLVER_CFG = dict(n_clusters=2, n_grids=64, sigma=0.15, d_g=1024,
                  kmeans_replicates=2, solver_tol=1e-3, seed=0)
SOLVER_N = 512
SOLVER_CASES = {
    "subspace": dict(solver="subspace", solver_iters=60),
    "lanczos": dict(solver="lanczos", solver_iters=60),
    "compressive": dict(solver="compressive", solver_iters=60,
                        compressive_degree=32),
    "randomized": dict(solver="randomized", solver_iters=60),
    "auto": dict(solver="auto", solver_iters=60, compressive_degree=32,
                 compressive_auto_n=256),
}
WORLD4_CASES = ("lobpcg", "randomized")
DENSE_ROWS = 4


def _catch(fn, *args, **kw):
    """The exception type and message of ``fn(*args, **kw)``, or None."""
    try:
        fn(*args, **kw)
    except Exception as e:                    # noqa: BLE001 — reported
        return type(e).__name__, str(e)
    return None


def _solver_config(name: str):
    """The scenario's config for one solver (flat kwargs, as the
    reference's test spells them)."""
    import warnings
    case = SOLVER_CASES.get(name, {"solver": name, "solver_iters": 60})
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        return SCRBConfig(**SOLVER_CFG, **case)


def _injected_cell(x, cfg, plan, draws):
    """The compressive cell on the plan's rows (this rank's, under a mesh)
    with the reference's probe and signal blocks, subset rows and k-means
    seeds injected: the global labels, the Ritz values and the Gram
    products."""
    from repro_torch.core import compressive, executor
    from repro_torch.core.kmeans import row_normalize
    from repro_torch.utils import fold_seed
    probes, signals, rows, init = draws
    rep = executor.representation(plan)
    feats = rep.fit_transform(torch.from_numpy(x), plan.feature_map, cfg,
                              plan, cfg.seed, torch.device("cpu"))
    z = rep.from_features(feats, cfg, plan, torch.device("cpu"))
    comp = compressive.compressive_embed(
        z, cfg.n_clusters, fold_seed(cfg.seed, "eig"), cfg,
        probe_block=probes, signal_block=signals)
    km, _ = compressive.subset_cluster(z, row_normalize(comp.embedding),
                                       cfg.seed, cfg, rows=rows,
                                       init=torch.from_numpy(init))
    return {"labels": km.labels.numpy(), "theta": comp.theta,
            "solver": "compressive", "iterations": comp.iterations}


def _solver_fits(sc, names, dense=False):
    """On this rank, at one thread (the ranks share the host's cores): a
    mesh fit of each solver in ``names`` on the scenario's rows, with the
    reference's RB grids and start block injected — for a solver the
    scenario has draws of (compressive), the cell with those draws
    instead; with ``dense``, the n < 3k fallback too."""
    import torch.distributed as dist

    from repro_torch.core import ExecutionPlan
    from repro_torch.core import featuremap as tfm
    from repro_torch.launch import mesh as lm

    torch.set_num_threads(1)
    mesh = lm.make_host_mesh(device_type="cpu")
    plan = ExecutionPlan(placement="mesh", mesh=mesh,
                         feature_map=tfm.RBMap.from_state(*sc["params"],
                                                          device="cpu"))
    out = {"rank": dist.get_rank()}
    for name in names:
        cfg = _solver_config(name)
        if name in sc["draws"]:
            out[name] = _injected_cell(sc["x"], cfg, plan, sc["draws"][name])
            continue
        res = SCRBModel.fit(sc["x"], cfg, plan=plan, x0=sc["x0"],
                            device="cpu").fit_result
        out[name] = {"labels": res.labels, "sig": res.singular_values,
                     "solver": res.diagnostics["solver"],
                     "iterations": res.diagnostics["solver_iterations"]}
    if dense:
        res = SCRBModel.fit(sc["x"][:DENSE_ROWS], _solver_config("lobpcg"),
                            plan=plan, device="cpu").fit_result
        out["dense"] = {"labels": res.labels, "sig": res.singular_values,
                        "iterations": res.diagnostics["solver_iterations"]}
    return out


def _world4(sc):
    """The world of 4 ranks: LOBPCG and the randomized sketch."""
    return _solver_fits(sc, WORLD4_CASES)


def _scenarios(x, params, u, sc):
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
    fmap = tfm.RBMap.from_state(*params, device="cpu")
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

    # every other solver, and the dense fallback, on the reference's
    # scenario
    out["solvers"] = _solver_fits(sc, ("lobpcg", *SOLVER_CASES),
                                  dense=True)
    return out


def _reference_params(cfg: dict):
    """The reference's RB grids for ``cfg`` (the draw its own single fit
    makes from ``cfg["seed"]``), as the port's map state."""
    import jax

    from repro.core import featuremap as jfm
    from repro.core import rb as jrb
    from repro.utils import fold_key
    params = jrb.make_rb_params(
        fold_key(jax.random.PRNGKey(cfg["seed"]), "rb"), cfg["n_grids"], 2,
        cfg["sigma"], cfg["d_g"])
    jmap = jfm.RBMap(n_grids=cfg["n_grids"], sigma=cfg["sigma"],
                     d_g=cfg["d_g"], params=params)
    return jmap.meta_dict(), jmap.state_dict()


@pytest.fixture(scope="module")
def solver_refs():
    """The reference's scenario: its rows, RB grids and start block, its
    single fit of each solver case but ``auto`` (and the compressive
    cell's draws), and the port's single fits with the same injections."""
    import warnings

    import jax
    import jax.numpy as jnp

    from repro.core import SCRBConfig as JConfig
    from repro.core import compressive as jcomp
    from repro.core import executor as jexec
    from repro.core.kmeans import _plusplus_init as j_plusplus_init
    from repro.utils import fold_key
    from repro_torch.core import ExecutionPlan
    from repro_torch.core import featuremap as tfm
    from repro_torch.core.eigensolver import lobpcg_block_width

    x, y = make_rings(SOLVER_N, 2, seed=0)
    k = SOLVER_CFG["n_clusters"]
    params = _reference_params(SOLVER_CFG)
    key = jax.random.PRNGKey(SOLVER_CFG["seed"])
    ekey, kkey = fold_key(key, "eig"), fold_key(key, "kmeans")
    x0 = np.asarray(jax.random.normal(
        ekey, (SOLVER_N, lobpcg_block_width(SOLVER_N, k, 4)), jnp.float32))
    ref, draws = {}, {}
    for name, case in SOLVER_CASES.items():
        if name == "auto":     # held to the port's compressive cell only
            continue
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            jcfg = JConfig(**SOLVER_CFG, **case)
        ref[name] = jexec.execute(jnp.asarray(x), jcfg, keep_state=True)
        if name != "compressive":     # auto runs the same cell
            continue
        jz, co = ref[name].state["z"], jcfg.compressive_options
        probes = np.array(jz.random_tall(fold_key(ekey, "count"),
                                         co.probes, dist="rademacher"))
        signals = np.array(jz.random_tall(
            fold_key(ekey, "signals"), jcomp.default_signals(k)))
        n_sub = int(min(SOLVER_N, max(k, jcomp.default_subset(SOLVER_N, k))))
        sub_seed = int(jax.random.randint(fold_key(kkey, "subset"), (), 0,
                                          np.iinfo(np.int32).max))
        rows = np.sort(np.random.default_rng(sub_seed).choice(
            SOLVER_N, size=n_sub, replace=False))
        sub = jnp.asarray(np.asarray(ref[name].state["u_hat"])[rows])
        init = np.stack([np.asarray(j_plusplus_init(kk, sub, k)) for kk in
                         jax.random.split(fold_key(kkey, "centroids"),
                                          SOLVER_CFG["kmeans_replicates"])])
        draws[name] = (probes, signals, rows, init)
    sc = dict(x=x, params=params, x0=x0, draws=draws)
    plan = ExecutionPlan(feature_map=tfm.RBMap.from_state(*params,
                                                          device="cpu"))
    port = {}
    threads = torch.get_num_threads()
    torch.set_num_threads(1)        # small shapes: no gain from threads
    try:
        for name in ("lobpcg", *SOLVER_CASES):
            cfg = _solver_config(name)
            if name in draws:
                port[name] = _injected_cell(x, cfg, plan, draws[name])
                continue
            res = SCRBModel.fit(x, cfg, plan=plan, x0=x0,
                                device="cpu").fit_result
            port[name] = {"labels": res.labels, "sig": res.singular_values,
                          "solver": res.diagnostics["solver"],
                          "iterations": res.diagnostics["solver_iterations"]}
        res = SCRBModel.fit(x[:DENSE_ROWS], _solver_config("lobpcg"),
                            plan=plan, device="cpu").fit_result
        port["dense"] = {"sig": res.singular_values}
    finally:
        torch.set_num_threads(threads)
    return dict(sc=sc, y=y, ref=ref, port=port)


@pytest.fixture(scope="module")
def world(solver_refs):
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
                      args=(x, (jmap.meta_dict(), jmap.state_dict()), u,
                            solver_refs["sc"]),
                      timeout_s=60.0, join_timeout_s=600.0)
    ref = jsc_rb(jnp.asarray(x), JConfig(**CFG))
    single = SCRBModel.fit(x, SCRBConfig(**CFG), device="cpu")
    return dict(x=x, y=y, u=u, want=np.asarray(adj.gram_matvec(u)),
                idx=np.asarray(idx), ranks=ranks,
                ref_acc=metrics.accuracy(ref.labels, y), single=single)


@pytest.fixture(scope="module")
def world4(solver_refs):
    """The 4-rank world's results, the 2-rank world's beside them."""
    from repro_torch.launch.world import run_world
    return run_world(_world4, 4, backend="gloo", args=(solver_refs["sc"],),
                     timeout_s=60.0, join_timeout_s=600.0)


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
    counts = streaming.chunked_bin_counts([idx], d=d, d_g=CFG["d_g"],
                                          device="cpu")
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
    assert set(errs) == {"rows", "dense"}
    assert errs["rows"][0] == "ValueError" and "divisible" in errs["rows"][1]
    assert errs["dense"][0] == "ValueError" and "ELL" in errs["dense"][1]


def _ritz(sig) -> np.ndarray:
    return np.asarray(sig, np.float64) ** 2


@pytest.mark.parametrize("solver", list(SOLVER_CASES))
def test_every_solver_under_the_mesh(world, solver_refs, solver):
    """The reference's mesh-solver scenario. Each solver's mesh fit, with
    the reference's RB grids and start block: the ranks in step, Ritz
    values within 1e-3 of the port's single fit with the same injections,
    labels at ARI ≥ 0.97 against the reference's single fit of the same
    solver. The compressive cell runs on the mesh rows with the
    reference's probe, signal, subset and seed draws injected; ``auto``
    is a whole mesh fit routed to that cell (``compressive_auto_n``),
    with the port's own draws, held to the port's single fit."""
    fits = [r["solvers"][solver] for r in world["ranks"]]
    single = solver_refs["port"][solver]
    assert fits[0]["iterations"] == fits[1]["iterations"]
    assert fits[0]["iterations"] >= 1
    np.testing.assert_array_equal(fits[0]["labels"], fits[1]["labels"])
    assert fits[0]["solver"] == single["solver"]
    assert fits[0]["labels"].shape == (SOLVER_N,)
    if solver == "compressive":
        np.testing.assert_allclose(fits[0]["theta"], single["theta"],
                                   atol=1e-3)
    else:
        np.testing.assert_allclose(_ritz(fits[0]["sig"]),
                                   _ritz(single["sig"]), atol=1e-3)
    want = single["labels"] if solver == "auto" \
        else solver_refs["ref"][solver].labels
    ari = metrics.adjusted_rand_index(fits[0]["labels"], want)
    assert ari >= 0.97, (solver, ari)


def test_auto_routes_to_the_compressive_cell_under_the_mesh(world):
    fits = world["ranks"][0]["solvers"]
    assert fits["auto"]["solver"] == "compressive"
    assert fits["lobpcg"]["solver"] == "lobpcg"


def test_dense_fallback_under_the_mesh(world, solver_refs):
    """n < 3k: 4 rows, K = 2, the exact dense solve on the global
    mat-vec."""
    fits = [r["solvers"]["dense"] for r in world["ranks"]]
    single = solver_refs["port"]["dense"]
    assert fits[0]["iterations"] == fits[1]["iterations"] == 1
    np.testing.assert_allclose(_ritz(fits[0]["sig"]), _ritz(single["sig"]),
                               atol=1e-5)
    np.testing.assert_array_equal(fits[0]["labels"], fits[1]["labels"])
    assert fits[0]["labels"].shape == (DENSE_ROWS,)


@pytest.mark.parametrize("solver", WORLD4_CASES)
def test_a_world_of_four_ranks_matches_two(world, world4, solver):
    """The 4-shard code on the CPU: the same solve as the world of 2."""
    two = world["ranks"][0]["solvers"][solver]
    assert [r["rank"] for r in world4] == [0, 1, 2, 3]
    fits = [r[solver] for r in world4]
    assert {f["iterations"] for f in fits} == {fits[0]["iterations"]}
    for f in fits[1:]:
        np.testing.assert_array_equal(f["labels"], fits[0]["labels"])
    np.testing.assert_allclose(_ritz(fits[0]["sig"]), _ritz(two["sig"]),
                               atol=1e-3)
    assert metrics.adjusted_rand_index(fits[0]["labels"],
                                       two["labels"]) >= 0.97


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
