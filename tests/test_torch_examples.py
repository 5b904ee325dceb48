"""The port's examples (``examples_torch/``) against the JAX package's
(``examples/``), at small sizes, on the CPU.

Each port example's ``run`` returns what it printed; the reference side
runs its example itself (``main`` with its flags, its entry points wrapped
to keep what they return) where its draws are its own, or makes the calls
its example makes with the same configs where the test needs a shorter
run. The reference's random draws (RB grids, the eigensolver's start
block, k-means++ seeds, the LM's weights) are injected into the port
through the examples' seams (``plan=``, ``params=``) or, for k-means
seeds, by wrapping the port's ``_kmeans``, so like is compared with like. Tolerances: labels ARI ≥ 0.99 (whole fits,
float32 sums in other orders); D, nnz and the k-means baseline's labels
exactly; each pretraining step's loss within 1e-5 relative; the pooled,
standardised embeddings within 1e-4 relative in norm (and entry by entry
against the reference's forward on the port's trained weights); the
median-heuristic sigma within 1e-5 relative; prefill logits within 1e-4
(float32).
"""
import dataclasses
import importlib.util
import io
import os
import subprocess
import sys
from contextlib import redirect_stdout
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one thread under xdist)

from repro.core import SCRBConfig as JConfig, SCRBModel as JModel
from repro.core import baselines as jbase
from repro.core.eigensolver import lobpcg_block_width
from repro.core.streaming import ChunkedDense
from repro.utils import fold_key
from repro_torch.core import baselines as tbase
from repro_torch.core import executor as texec
from repro_torch.core import featuremap as tfm
from repro_torch.core import metrics
from repro_torch.core import rowmatrix as trow
from repro_torch.models import transformer as T

ROOT = Path(__file__).resolve().parents[1]
NAMES = ("quickstart", "embed_cluster", "serve_predict", "serve_lm")
# the package __init__ files re-export a ``kmeans`` function over the module
jkm = importlib.import_module("repro.core.kmeans")
tkm = importlib.import_module("repro_torch.core.kmeans")


def _load(folder: str, name: str):
    """An example's file as a module (the folders are not packages)."""
    spec = importlib.util.spec_from_file_location(
        f"{folder}_{name}", ROOT / folder / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Small ops: torch's intra-op threads only contend, most of all with
    the other test processes of a parallel run."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _reference_main(mod, argv, monkeypatch) -> str:
    """The reference example's ``main`` under ``argv``; its printout."""
    monkeypatch.setattr(sys, "argv", [mod.__file__, *argv])
    buf = io.StringIO()
    with redirect_stdout(buf):
        mod.main()
    return buf.getvalue()


# --------------------------------------------------------------------------
# quickstart
# --------------------------------------------------------------------------

QS = dict(n=800, grids=96)


@pytest.fixture(scope="module", params=[None, 300], ids=["device", "chunk300"])
def quickstart(request):
    """The reference example at ``--n 800 --grids 96`` (and
    ``--chunk-size 300``), its fit and k-means baseline kept; the port's
    example on the same RB grids, start block and k-means++ seeds."""
    chunk = request.param
    ref = _load("examples", "quickstart")
    kept = {}

    def fit(x, cfg):
        kept["model"] = JModel.fit(x, cfg)
        kept["cfg"] = cfg
        return kept["model"].fit_result

    def kmeans(x, cfg):
        kept["x"], kept["kcfg"] = np.asarray(x), cfg
        kept["km"] = jbase.METHODS["kmeans"](x, cfg)
        return kept["km"]

    argv = ["--n", str(QS["n"]), "--grids", str(QS["grids"])]
    if chunk:
        argv += ["--chunk-size", str(chunk)]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ref, "sc_rb", fit)
        mp.setattr(ref, "METHODS", {"kmeans": kmeans})
        printed = _reference_main(ref, argv, mp)
    jmodel, jcfg = kept["model"], kept["cfg"]
    n = QS["n"]
    key = jax.random.PRNGKey(jcfg.seed)
    b = lobpcg_block_width(n, jcfg.n_clusters, jcfg.solver_options.buffer)
    if chunk:
        sizes = [min(chunk, n - s) for s in range(0, n, chunk)]
        x0 = ChunkedDense.random_normal(fold_key(key, "eig"), sizes,
                                        b).to_array()
    else:
        x0 = np.asarray(jax.random.normal(fold_key(key, "eig"), (n, b),
                                          jnp.float32))
    jmap = jmodel.feature_map
    tmap = tfm.RBMap.from_state(jmap.meta_dict(), jmap.state_dict(),
                                device="cpu")
    kcfg = kept["kcfg"]
    keys = jax.random.split(fold_key(jax.random.PRNGKey(kcfg.seed),
                                     "kmeans"), kcfg.kmeans_replicates)
    inits = np.stack([np.asarray(jkm._plusplus_init(
        kk, jnp.asarray(kept["x"]), kcfg.n_clusters)) for kk in keys])
    tcfg = texec.SCRBConfig(n_clusters=2, n_grids=QS["grids"], sigma=0.15,
                            kmeans_replicates=4, chunk_size=chunk)
    plan = dataclasses.replace(texec.plan_from_config(tcfg),
                               feature_map=tmap, eig_x0=x0)
    port = _load("examples_torch", "quickstart")
    lines = []

    def seeded(gen, x, k, **kw):
        """The baseline's k-means from the reference's k-means++ draws."""
        return tkm.kmeans(gen, x, k, init=torch.from_numpy(inits), **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tbase, "_kmeans", seeded)
        got = port.run(QS["n"], QS["grids"], chunk, device="cpu", plan=plan,
                       log=lines.append)
    return dict(chunk=chunk, ref=jmodel.fit_result, ref_km=kept["km"],
                printed=printed, got=got, lines=lines)


def test_quickstart_labels_match_reference(quickstart):
    ari = metrics.adjusted_rand_index(quickstart["got"]["labels"],
                                      quickstart["ref"].labels)
    assert ari >= 0.99, ari


def test_quickstart_features_equal_reference(quickstart):
    got, want = quickstart["got"]["diagnostics"], quickstart["ref"].diagnostics
    assert got["n_features_D"] == want["n_features_D"]
    assert got["nnz"] == want["nnz"]
    if quickstart["chunk"]:
        assert got["n_chunks"] == want["n_chunks"]
        assert got["ell_device_bytes_peak"] == want["ell_device_bytes_peak"]


def test_quickstart_kmeans_baseline_equals_reference(quickstart):
    np.testing.assert_array_equal(quickstart["got"]["kmeans_labels"],
                                  quickstart["ref_km"].labels)


def test_quickstart_prints_the_reference_lines(quickstart):
    """The same lines, in order, each starting as the reference's does."""
    want = [s for s in quickstart["printed"].splitlines() if s.strip()]
    got = [str(s) for s in quickstart["lines"]]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.split(":")[0] == w.split(":")[0], (g, w)


def test_quickstart_chunked_labels_equal_unchunked():
    """The docstring's claim: streaming gives the labels of the one-shot
    fit, up to permutation (the port's own draws)."""
    port = _load("examples_torch", "quickstart")
    quiet = dict(device="cpu", log=lambda *a: None)
    whole = port.run(QS["n"], QS["grids"], **quiet)
    chunked = port.run(QS["n"], QS["grids"], 300, **quiet)
    assert chunked["diagnostics"]["n_chunks"] == 3
    assert metrics.adjusted_rand_index(chunked["labels"],
                                       whole["labels"]) == 1.0


# --------------------------------------------------------------------------
# embed_cluster
# --------------------------------------------------------------------------

EC = dict(docs=240, seq=16, topics=3, steps=5)


@pytest.fixture(scope="module")
def embed_cluster():
    """The reference example's calls at 240 docs, seq 16, 3 topics and 5
    pretraining steps from one set of weights (drawn by the port, carried
    to both), then the port's example from the same weights with the
    reference fit's RB grids and start block."""
    from repro.core.rb import suggest_sigma as jsuggest
    from repro.models import transformer as JT
    from repro.train.optimizer import OptConfig as JOpt
    from repro.train.trainer import TrainConfig as JTrain, Trainer as JTrainer
    ref = _load("examples", "embed_cluster")
    port = _load("examples_torch", "embed_cluster")
    docs, topics = ref.topic_corpus(EC["docs"], EC["seq"], 4_096,
                                    EC["topics"])
    jcfg, tcfg = ref.tiny_lm(4_096), port.tiny_lm(4_096)
    tree = T.params_to_reference(tcfg, T.init_params(
        tcfg, 0, device="cpu", masters=True))

    def lm_batches():
        rng = np.random.default_rng(1)
        while True:
            toks = docs[rng.integers(0, EC["docs"], size=16)]
            yield {"tokens": jnp.asarray(toks[:, :-1]),
                   "labels": jnp.asarray(toks[:, 1:])}

    trainer = JTrainer(jcfg, JTrain(
        opt=JOpt(lr=3e-3, warmup_steps=10, total_steps=EC["steps"]),
        log_every=50), jax.tree_util.tree_map(jnp.asarray, tree),
        lm_batches())
    losses = [trainer.run(1)["loss"] for _ in range(EC["steps"])]
    params = trainer.params

    @jax.jit
    def embed(tokens):
        h, _ = JT.forward_hidden(jcfg, params, {"tokens": tokens})
        return h.mean(axis=1)

    x = np.concatenate([np.asarray(embed(jnp.asarray(docs[i:i + 200])))
                        for i in range(0, EC["docs"], 200)])
    x = (x - x.mean(0)) / (x.std(0) + 1e-6)
    sigma = jsuggest(x)
    n_fit = x.shape[0] // 2
    jmodel = JModel.fit(x[:n_fit], JConfig(
        n_clusters=EC["topics"], n_grids=256, sigma=sigma,
        kmeans_replicates=4))
    key = jax.random.PRNGKey(jmodel.config.seed)
    b = lobpcg_block_width(n_fit, EC["topics"],
                           jmodel.config.solver_options.buffer)
    x0 = np.asarray(jax.random.normal(fold_key(key, "eig"), (n_fit, b),
                                      jnp.float32))
    jmap = jmodel.feature_map
    tmap = tfm.RBMap.from_state(jmap.meta_dict(), jmap.state_dict(),
                                device="cpu")
    kkeys = jax.random.split(fold_key(key, "kmeans"),
                             jmodel.config.kmeans_replicates)

    def seeded(gen, u, k, **kw):
        """The fit's k-means from the reference fit's k-means++ draws, made
        on the port's embedding (distances: a rotation leaves them alone)."""
        init = np.stack([np.asarray(jkm._plusplus_init(
            kk, jnp.asarray(u.numpy()), k)) for kk in kkeys])
        return tkm.kmeans(gen, u, k, init=torch.from_numpy(init), **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(trow, "_kmeans", seeded)
        got = port.run(EC["docs"], EC["seq"], EC["topics"], device="cpu",
                       steps=EC["steps"],
                       params=T.params_from_reference(tcfg, tree,
                                                      device="cpu",
                                                      masters=True),
                       plan=texec.ExecutionPlan(feature_map=tmap, eig_x0=x0),
                       log=lambda *a: None)
    return dict(docs=docs, topics=topics, jcfg=jcfg, port_corpus=port.topic_corpus(
        EC["docs"], EC["seq"], 4_096, EC["topics"]), losses=losses, x=x,
        sigma=sigma, labels=jmodel.fit_result.labels, got=got)


def test_embed_cluster_corpus_equals_reference(embed_cluster):
    docs, topics = embed_cluster["port_corpus"]
    np.testing.assert_array_equal(docs, embed_cluster["docs"])
    np.testing.assert_array_equal(topics, embed_cluster["topics"])


def test_embed_cluster_pretraining_losses_match(embed_cluster):
    np.testing.assert_allclose(embed_cluster["got"]["losses"],
                               embed_cluster["losses"], rtol=1e-5)


def test_embed_cluster_embeddings_and_sigma_match(embed_cluster):
    """Across the two pretrainings the embeddings agree as a whole (AdamW's
    first steps turn gradients near its eps into updates of either sign,
    ROADMAP.md C16, so single entries drift further); the reference's
    forward on the port's own trained weights gives the port's embeddings
    entry by entry."""
    from repro.models import transformer as JT
    got = embed_cluster["got"]
    x, want = got["embeddings"], embed_cluster["x"]
    assert np.linalg.norm(x - want) <= 1e-4 * np.linalg.norm(want)
    assert got["sigma"] == pytest.approx(embed_cluster["sigma"], rel=1e-5)
    cfg = got["lm_config"]
    tree = jax.tree_util.tree_map(
        jnp.asarray, T.params_to_reference(cfg, got["lm"]))
    docs = embed_cluster["docs"]
    h = np.concatenate([np.asarray(JT.forward_hidden(
        embed_cluster["jcfg"], tree, {"tokens": jnp.asarray(docs[i:i + 200])}
    )[0]).mean(axis=1) for i in range(0, EC["docs"], 200)])
    h = (h - h.mean(0)) / (h.std(0) + 1e-6)
    np.testing.assert_allclose(x, h, atol=1e-4, rtol=0)


def test_embed_cluster_fit_labels_match(embed_cluster):
    ari = metrics.adjusted_rand_index(embed_cluster["got"]["fit_labels"],
                                      embed_cluster["labels"])
    assert ari >= 0.99, ari


def test_embed_cluster_reloaded_predict_is_bit_identical(embed_cluster):
    got = embed_cluster["got"]
    assert got["reloaded_identical"] is True
    assert got["served"].shape == (EC["docs"] - EC["docs"] // 2,)


# --------------------------------------------------------------------------
# serve_predict
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def serve_predict():
    """The reference example run as it is (the stats it printed kept), and the
    port's example, each at the example's own sizes."""
    ref = _load("examples", "serve_predict")
    stats = []

    class Kept(ref.ClusterEngine):
        def stats(self, *a, **kw):
            stats.append(super().stats(*a, **kw))
            return stats[-1]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ref, "ClusterEngine", Kept)
        _reference_main(ref, [], mp)
    port = _load("examples_torch", "serve_predict")
    return dict(ref_stats=stats[0],
                got=port.run(device="cpu", log=lambda *a: None))


def test_serve_predict_engine_equals_model(serve_predict):
    assert serve_predict["got"]["engine_equals_model"] is True


def test_serve_predict_stats_as_the_reference(serve_predict):
    """The reference engine's keys (the port adds ``slots``,
    ``slots_freed`` and ``replayed_launches``, see ``ClusterEngine``), and
    the same traffic: the requests are drawn from the same seed."""
    got, want = serve_predict["got"]["stats"], serve_predict["ref_stats"]
    extra = {"slots", "slots_freed", "replayed_launches"}
    assert set(got) - extra == set(want)
    for key in ("total_compiles", "cells", "rows_served", "batches",
                "padded_rows", "resident"):
        assert got[key] == want[key], key


def test_serve_predict_http_answers_as_the_engine(serve_predict):
    got = serve_predict["got"]
    assert got["http"] == {"labels": got["engine_predict_http_rows"].tolist()}


# --------------------------------------------------------------------------
# serve_lm
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def serve_lm():
    from repro.serve.engine import Engine as JEngine, ServeConfig as JServe
    ref = _load("examples", "serve_lm")
    port = _load("examples_torch", "serve_lm")
    tcfg, jcfg = port.tiny_lm(), ref.tiny_lm()
    tree = T.params_to_reference(tcfg, T.init_params(tcfg, 0, device="cpu"))
    params = T.params_from_reference(tcfg, tree, device="cpu")
    quiet = lambda *a: None
    got = port.run(device="cpu", params=params, log=quiet)
    again = port.run(device="cpu", params=params, log=quiet)
    b, p, new = 4, 16, 32
    jeng = JEngine(jcfg, jax.tree_util.tree_map(jnp.asarray, tree),
                   JServe(cache_len=p + new, batch_size=b, temperature=0.8))
    from repro.models import transformer as JT
    want, _ = jeng._prefill(jeng.params,
                            {"tokens": jnp.asarray(got["prompts"])},
                            JT.init_cache(jcfg, b, p + new))
    caches = T.init_cache(tcfg, b, p + new, device="cpu")
    logits, _ = T.prefill(tcfg, params,
                          {"tokens": torch.as_tensor(got["prompts"])},
                          caches)
    return dict(got=got, again=again, logits=logits.float().numpy(),
                want=np.asarray(want, np.float32), cfg=tcfg)


def test_serve_lm_prefill_logits_match_reference(serve_lm):
    np.testing.assert_allclose(serve_lm["logits"], serve_lm["want"],
                               atol=1e-4, rtol=0)


def test_serve_lm_samples_in_range_and_repeat(serve_lm):
    toks = serve_lm["got"]["tokens"]
    assert toks.shape == (4, 32) and toks.dtype == np.int32
    assert toks.min() >= 0 and toks.max() < serve_lm["cfg"].vocab_size
    np.testing.assert_array_equal(toks, serve_lm["again"]["tokens"])
    assert serve_lm["got"]["model"] == "serve-demo-8m"


def test_serve_lm_refuses_an_embeds_arch():
    port = _load("examples_torch", "serve_lm")
    with pytest.raises(SystemExit, match="takes embeds input"):
        port.main(["--arch", "musicgen-large", "--device", "cpu"])


# --------------------------------------------------------------------------
# the command lines: the CPU only when asked, and no JAX
# --------------------------------------------------------------------------

SMALL_ARGS = {"quickstart": ["--n", "400", "--grids", "32"],
              "embed_cluster": ["--docs", "64", "--seq", "8",
                                "--topics", "2"],
              "serve_predict": [],
              "serve_lm": ["--max-new", "4"]}

CLI = """
import runpy, sys
sys.argv = sys.argv[1:]
runpy.run_path(sys.argv[0], run_name="__main__")
loaded = [m for m in sys.modules
          if m.split(".")[0] in ("jax", "jaxlib", "repro")]
print("LOADED", loaded)
sys.exit(1 if loaded else 0)
"""


@pytest.mark.parametrize("name", NAMES)
def test_cli_on_the_cpu_loads_no_jax(name):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-c", CLI, str(ROOT / "examples_torch" /
                                        f"{name}.py"),
         *SMALL_ARGS[name], "--device", "cpu"],
        env=env, capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "LOADED []" in out.stdout


@pytest.mark.parametrize("name", NAMES)
def test_cli_without_a_card_raises(name):
    """Without ``--device cpu`` an example asks for the card and raises
    where there is none; it never carries on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    mod = _load("examples_torch", name)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main(SMALL_ARGS[name])
