"""The port's 2-D (data, model) training mode
(``crnerf_tpu_torch/parallel/tp.py``) on the CPU, against the JAX package's
``crnerf_tpu/parallel/tp.py`` and against the port's one-process step.

- The split rule: at tests/test_train.py's TINY config and at the flagship
  config, for n_model 2 and 4, the port splits exactly the parameters that
  JAX's ``tp_state_sharding`` splits, each on the dim the weight bridge's
  layout maps flax's last dim to (63 split and 98 replicated at the
  flagship). On ``jax.eval_shape`` exemplars, in this process.
- The step: four gloo ranks (data 2 x model 2, spawned as
  tests/test_torch_parallel.py spawns its two) run two steps of G = 4 grids
  from the JAX initialisation (the bridge), on the same batches and the
  random numbers the JAX step draws (replayed). Against JAX's
  ``shard_train_step_tp`` on ``make_mesh_2d(2, 2)`` of the 8 virtual CPU
  devices: step 1's metrics, per-leaf gradients and parameter deltas within
  the port's one-step bounds against JAX (tests/test_torch_parallel.py's);
  step 2's loss within 5e-4 (tests/test_tp.py's). Against the port's
  one-process step of 4 grids: step-1 parameters within rtol 1e-3 + 2e-5
  and the loss within 2e-5 (tests/test_tp.py's bounds), the cache's
  validity equal and its rows the same bits after step 1.
- One Ranger step (its centralisation groups by output unit) against the
  one-process Ranger step: the first moments and the parameters.
- The split is real: each rank's split leaves and their Adam moments hold
  out / n_model rows, and under FlopCounterMode a model rank's forward
  counts the matmul and convolution FLOPs that read split leaves at 1 /
  n_model of one process's, the rest unchanged.
- The replicas: after two steps the replicated leaves, the cache and the
  BatchNorm statistics are the same bits on all four ranks, a split leaf
  the same bits on the two data ranks of its model index.
- One process (the 1 x 1 mesh) gives make_train_step's bits; the three
  refusals (pallas_train=True, a world that is not n_data x n_model, G not
  a multiple of n_data) raise.

TINY (4 x 4 rays a grid, 2 layers x 16) at fp32, pallas_train=False (the
JAX mode's pure-XLA route), perturb 0 and N_emb_xyz 10 (as
tests/test_torch_train_step.py: at 15 octaves the two frameworks' one-ulp
differences in z become ~1e-2 in sin(2^14 x)). oneDNN is off in the port's
steps, as in tests/test_torch_parallel.py.
"""

import concurrent.futures
import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_train import TINY, _batch
from torch_tp_ranks import gathered_out, port_state, rank_job, tiny_state

from crnerf_tpu.config import Config
from crnerf_tpu.parallel.tp import MODEL_AXIS as JAX_MODEL_AXIS
from crnerf_tpu.parallel.tp import make_mesh_2d as jax_mesh_2d
from crnerf_tpu.parallel.tp import shard_train_step_tp as jax_tp_step
from crnerf_tpu.parallel.tp import tp_state_sharding
from crnerf_tpu.render.system import CrNerfSystem as JaxSystem
from crnerf_tpu.train.optim import make_optimizer as jax_make_optimizer
from crnerf_tpu.train.state import TrainState as JaxTrainState
from crnerf_tpu.train.step import make_train_step as jax_make_train_step
from crnerf_tpu_torch import Config as PortConfig
from crnerf_tpu_torch.parallel import mesh, tp
from crnerf_tpu_torch.render.system import CrNerfSystem
from crnerf_tpu_torch.train.step import make_train_step, reduce_metrics
from crnerf_tpu_torch.utils import weights as bridge

torch.set_num_threads(2)

N_DATA, N_MODEL, G, N_STEPS = 2, 2, 4, 2
CFG = Config(**TINY).replace(perturb=0.0, pallas_train=False,
                             use_pallas=False, compute_dtype="float32",
                             N_emb_xyz=10, grids_per_step=G)
FLAGSHIP = Config(appearance_wh=(224, 160))
# the ranks run tests/torch_tp_ranks.py, which imports no jax
RANK_ENV = {"OMP_NUM_THREADS": "1"}


def port_cfg(cfg):
    return PortConfig(**{f.name: getattr(cfg, f.name)
                         for f in dataclasses.fields(PortConfig)})


TCFG = port_cfg(CFG)
RANGER_CFG = dataclasses.replace(TCFG, optimizer="ranger")


def _flat(tree):
    return bridge.flatten(jax.tree.map(np.asarray, tree))


def replay_draws(rng, valid):
    """The numbers the JAX step of G grids draws from ``rng`` with the
    cache validity ``valid`` (tests/test_torch_train_step.py
    ``replay_draws`` at this file's G and sizes), as the port's draws."""
    _, kstep, ksel = jax.random.split(rng, 3)
    n = valid.shape[0]
    idx = [int(jnp.argmax(jnp.where(valid, jax.random.gumbel(k, (n,)),
                                    -jnp.inf)))
           for k in jax.random.split(ksel, G)]
    b, s, i = CFG.batch_size, CFG.N_samples, CFG.N_importance
    per = {"z_u": [], "noise_coarse": [], "noise_fine": [], "pdf_e": []}
    for key in jax.random.split(kstep, G):
        (kf,) = jax.random.split(key, 1)
        kz, kn_c, kn_f, kpdf, _, _ = jax.random.split(kf, 6)
        per["z_u"].append(jax.random.uniform(kz, (b, s), jnp.float32))
        per["noise_coarse"].append(
            CFG.noise_std * jax.random.normal(kn_c, (b, s), jnp.float32))
        per["noise_fine"].append(
            CFG.noise_std * jax.random.normal(kn_f, (b, s + i), jnp.float32))
        per["pdf_e"].append(
            jax.random.exponential(kpdf, (b, i + 1), dtype=jnp.float32))
    draws = {k: torch.from_numpy(np.stack([np.asarray(a) for a in v]))
             for k, v in per.items()}
    draws["sel_idx"] = torch.tensor(idx, dtype=torch.int64)
    return draws


def global_batch(seed):
    """G grids of test_train's synthetic batch, grid i of image i."""
    parts = [_batch(CFG, seed=seed + s) for s in range(G)]
    for i, p in enumerate(parts):
        p["ts"][:] = i
    return {k: np.stack([p[k] for p in parts]) for k in parts[0]}


def port_side(sd, batches, draws, path):
    """The port's two steps in one process of G grids, its one Ranger
    step, and its four ranks (tests/torch_tp_ranks.py, writing beside
    ``path``) -> (the one process's outputs, the Ranger step's)."""
    state, psched = port_state(TCFG, sd)
    one_step = make_train_step(state.system, state.optimizer, psched, G)
    single = []
    with torch.backends.mkldnn.flags(enabled=False):
        for b, d in zip(batches, draws):
            state, m = one_step(state, b, d)
            single.append(gathered_out(state, reduce_metrics(m, None)))
        state, psched = port_state(RANGER_CFG, sd)
        state, _ = make_train_step(state.system, state.optimizer, psched,
                                   G)(state, batches[0], draws[0])
        single_ranger = gathered_out(state, {})

    torch.save(dict(cfg=TCFG, ranger_cfg=RANGER_CFG, mesh=(N_DATA, N_MODEL),
                    grids=G, sd=sd, batches=batches, draws=draws), path)
    mesh.spawn(rank_job, N_DATA * N_MODEL, (path,), timeout=300)
    return single, single_ranger


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Two steps on the JAX 2 x 2 mesh, on the port's four ranks and in
    one port process of G grids. XLA compiles the JAX step, lowered on
    the module's state exemplar, while the JAX initialisation runs and
    then while the port's side does: each step's draws are replayed from
    the key and cache validity that the JAX step starts from, known before
    it runs (crnerf_tpu/train/step.py keeps the first of the three keys it
    splits from its own and marks each grid's ts valid; both are checked
    against the JAX step's)."""
    jsys = JaxSystem(CFG)
    tx, sched = jax_make_optimizer(CFG, 10)
    batches = [global_batch(100 * i) for i in range(N_STEPS)]
    jstep, state_sh, batch_sh = jax_tp_step(
        jax_make_train_step(jsys, tx, sched, grids_per_step=G),
        _jax_state_shape("tiny"), batches[0], jax_mesh_2d(N_DATA, N_MODEL))
    path = str(tmp_path_factory.mktemp("tp") / "job.pt")
    saved = {k: os.environ.get(k) for k in RANK_ENV}
    os.environ.update(RANK_ENV)
    try:
        with concurrent.futures.ThreadPoolExecutor(2) as pool:
            compiled = pool.submit(lambda: jstep.lower(
                _jax_state_shape("tiny"),
                jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype),
                             batches[0])).compile())
            variables = jax.jit(jsys.init)(jax.random.PRNGKey(0))
            jstate = JaxTrainState.create(
                variables, tx.init(variables["params"]), n_vocab=CFG.N_vocab,
                embed_hw=32, embed_c=CFG.nerf_out_dim,
                rng=jax.random.PRNGKey(1))
            keys, valids = [jstate.rng], [np.asarray(jstate.embedding_valid)]
            draws = []
            for b in batches:
                draws.append(replay_draws(keys[-1], valids[-1]))
                keys.append(jax.random.split(keys[-1], 3)[0])
                valids.append(valids[-1].copy())
                valids[-1][b["ts"][:, 0]] = True

            port_sys = bridge.load_into(CrNerfSystem(TCFG),
                                        jax.tree.map(np.asarray, variables))
            sd = {k: v.clone() for k, v in port_sys.state_dict().items()}
            tb = [{k: torch.from_numpy(v) for k, v in b.items()}
                  for b in batches]
            port = pool.submit(port_side, sd, tb, draws, path)

            st = jax.device_put(jstate, state_sh)
            jax_steps = []
            for i, b in enumerate(batches):
                before = _flat(st.params)
                st, jm = compiled.result()(st, jax.device_put(b, batch_sh))
                np.testing.assert_array_equal(np.asarray(st.rng),
                                              np.asarray(keys[i + 1]))
                np.testing.assert_array_equal(np.asarray(st.embedding_valid),
                                              valids[i + 1])
                jax_steps.append(dict(
                    before=before, params=_flat(st.params),
                    mu=_flat(st.opt_state[0].mu),
                    valid=np.asarray(st.embedding_valid),
                    metrics={k: float(v) for k, v in jm.items()}))
            single, single_ranger = port.result()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k)
            else:
                os.environ[k] = v
    ranks = [torch.load(path + f".rank{r}", weights_only=False)
             for r in range(N_DATA * N_MODEL)]
    return dict(jax=jax_steps, single=single, ranks=ranks,
                lr=float(sched(0)), sd=sd, single_ranger=single_ranger)


# ---------------------------------------------------------------- the rule

# the systems of test_split_rule_matches_jax: "group" is CFG with
# CGNet's GroupNorm, whose scale and bias (rank 1) stay replicated
SPLIT_CFGS = {"tiny": CFG, "flagship": FLAGSHIP,
              "group": CFG.replace(norm="group")}


@functools.cache
def _jax_state_shape(which):
    """An eval_shape exemplar of the JAX train state of SPLIT_CFGS[which],
    traced once for both n_model."""
    cfg = SPLIT_CFGS[which]

    def make():
        variables = JaxSystem(cfg).init(jax.random.PRNGKey(0))
        tx, _ = jax_make_optimizer(cfg, 10)
        return JaxTrainState.create(
            variables, tx.init(variables["params"]), n_vocab=cfg.N_vocab,
            embed_hw=32, embed_c=cfg.nerf_out_dim,
            rng=jax.random.PRNGKey(1))

    return jax.eval_shape(make)


def _jax_split(which, n_model):
    """{flax params leaf: (shape, spec)} of JAX's tp_state_sharding on the
    state exemplar."""
    state = _jax_state_shape(which)
    sh = tp_state_sharding(state, jax_mesh_2d(2, n_model))
    shapes = {jax.tree_util.keystr(p): x.shape for p, x in
              jax.tree_util.tree_flatten_with_path(state.params)[0]}
    specs = {jax.tree_util.keystr(p): tuple(s.spec) for p, s in
             jax.tree_util.tree_flatten_with_path(sh.params)[0]}
    return {k: (shapes[k], specs[k]) for k in shapes}


@pytest.mark.parametrize("n_model", (2, 4))
@pytest.mark.parametrize("which", ("tiny", "flagship", "group"))
def test_split_rule_matches_jax(which, n_model):
    cfg = SPLIT_CFGS[which]
    jax_leaves = _jax_split(which, n_model)
    # the flax leaves under the port's names, through the bridge
    zeros = {}
    for k, (shape, _) in jax_leaves.items():
        node = zeros
        parts = [p.strip("[]'") for p in k.split("][")]
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = np.zeros(shape, np.float32)
    to_port = dict(zip(bridge.flatten(zeros),
                       bridge.state_dict_from_flax({"params": zeros})))
    jax_split = {}
    for k, (shape, spec) in jax_leaves.items():
        name = to_port[".".join(p.strip("[]'") for p in k.split("]["))]
        if JAX_MODEL_AXIS in spec:
            assert spec.index(JAX_MODEL_AXIS) == len(shape) - 1, k
            jax_split[name] = shape[-1]
    system = CrNerfSystem(port_cfg(cfg))
    port = dict(system.named_parameters())
    assert set(port) == set(to_port.values())
    port_split = {}
    for k, p in port.items():
        dim = tp.split_dim(k, p.shape, n_model)
        if dim is not None:
            assert dim == 0, k
            port_split[k] = p.shape[0]
    assert port_split == jax_split
    if which == "flagship":
        assert (len(port_split), len(port) - len(port_split)) == (63, 98)
        assert sum(port[k].numel() for k in port_split) == 4039072
    if which == "group":
        gn = [k for k in port if ".GroupNorm_0." in k]
        assert len(gn) == 28 and not set(gn) & set(port_split)


# ------------------------------------------------------- the step vs JAX

def test_step1_metrics_match_the_jax_tp_step(run):
    """loss, psnr and every term: 1e-4 relative + 1e-7 (psnr 1e-3 dB), the
    port's first-step bounds against JAX, on the data ranks' mean."""
    jm, pm = run["jax"][0]["metrics"], run["ranks"][0]["steps"][0]["metrics"]
    assert set(jm) == set(pm)
    for k in jm:
        tol = dict(rtol=1e-4, atol=1e-3) if k == "psnr" else dict(
            rtol=1e-4, atol=1e-7)
        np.testing.assert_allclose(pm[k], jm[k], err_msg=k, **tol)


def test_step1_gradients_and_deltas_match_the_jax_tp_step(run):
    """Adam's first moment after one step is 0.1 g: per leaf within 2e-3
    of the leaf's largest + 1e-7, CGNet's 5e-2 (the JAX side's fp32 CGNet,
    tests/test_torch_train_step.py). Parameter deltas: every element within
    2 lr; elements whose gradient exceeds 1e-5 within 2% of lr, CGNet's
    held to 2 lr only (tests/test_torch_parallel.py's bounds)."""
    jstep, out = run["jax"][0], run["ranks"][0]["steps"][0]
    jg = {k: v / 0.1 for k, v in jstep["mu"].items()}
    pg = {k: v / 0.1 for k, v in out["mu"].items()}
    assert set(jg) == set(pg)
    for k in jg:
        rel = 5e-2 if k.startswith("implicit_mask.") else 2e-3
        np.testing.assert_allclose(pg[k], jg[k], err_msg=k,
                                   atol=rel * np.abs(jg[k]).max() + 1e-7)
    lr, n_checked = run["lr"], 0
    for k, new in jstep["params"].items():
        d_j, d_p = new - jstep["before"][k], out["params"][k] - jstep[
            "before"][k]
        assert np.abs(d_p - d_j).max() <= 2 * lr + 1e-9, k
        if k.startswith("implicit_mask."):
            continue
        big = np.abs(jg[k]) > 1e-5
        n_checked += int(big.sum())
        if big.any():
            np.testing.assert_allclose(d_p[big], d_j[big], atol=0.02 * lr,
                                       err_msg=k)
    assert n_checked > 1000


def test_step2_loss_matches_the_jax_tp_step(run):
    """tests/test_tp.py's step-2 bound."""
    np.testing.assert_allclose(
        run["ranks"][0]["steps"][1]["metrics"]["loss"],
        run["jax"][1]["metrics"]["loss"], rtol=5e-4)


# -------------------------------------------- the step vs one process

def test_step1_parameters_match_the_one_process_step(run):
    """tests/test_tp.py's bounds: parameters after one step rtol 1e-3 +
    2e-5, the statistics likewise."""
    out, one = run["ranks"][0]["steps"][0], run["single"][0]
    for part in ("params", "stats"):
        assert set(out[part]) == set(one[part])
        for k, v in one[part].items():
            np.testing.assert_allclose(out[part][k], v, rtol=1e-3,
                                       atol=2e-5, err_msg=k)


@pytest.mark.parametrize("i", range(N_STEPS))
def test_loss_matches_the_one_process_step(run, i):
    """Step 1 within 2e-5 relative, step 2 within 5e-4 (tests/test_tp.py's
    bounds, from parameters that differ by step 1's rounding)."""
    np.testing.assert_allclose(
        run["ranks"][0]["steps"][i]["metrics"]["loss"],
        run["single"][i]["metrics"]["loss"], rtol=2e-5 if i == 0 else 5e-4)


@pytest.mark.parametrize("i", range(N_STEPS))
def test_cache_matches_the_one_process_step(run, i):
    """The valid rows are the same rows, every grid's ts among them, as in
    JAX's step. Step 1's rows are the one-process step's bits (each output
    channel of a split convolution is summed as in one process, and
    without oneDNN a convolution's sample does not depend on its batch);
    step 2's come from parameters that step 1's rounding already set
    apart (tests/test_tp.py's parameter bound): within 1e-5."""
    out, one = run["ranks"][0]["steps"][i], run["single"][i]
    assert torch.equal(out["valid"], one["valid"])
    np.testing.assert_array_equal(out["valid"].numpy(), run["jax"][i]
                                  ["valid"])
    assert int(out["valid"].sum()) == G
    if i == 0:
        assert torch.equal(out["cache"], one["cache"])
    else:
        np.testing.assert_allclose(out["cache"].numpy(),
                                   one["cache"].numpy(), atol=1e-5)


def test_ranger_step_matches_the_one_process_step(run):
    """Ranger centralises each gradient by output unit, and a row split
    keeps every unit on one rank: its first moment (of the centralised
    gradient) per leaf within 1e-4 of the leaf's largest + 1e-9, CGNet's
    5e-4 (tests/test_torch_parallel.py's bounds for another order of the
    same sums), the parameters within tests/test_tp.py's bounds."""
    one = run["single_ranger"]
    for r in run["ranks"]:
        got = r["ranger"]
        assert set(got["mu"]) == set(one["mu"])
        for k, v in one["mu"].items():
            rel = 5e-4 if k.startswith("implicit_mask.") else 1e-4
            np.testing.assert_allclose(got["mu"][k], v, err_msg=k,
                                       atol=rel * np.abs(v).max() + 1e-9)
        for k, v in one["params"].items():
            np.testing.assert_allclose(got["params"][k], v, rtol=1e-3,
                                       atol=2e-5, err_msg=k)


# ------------------------------------------------------ the split is real

def test_split_leaves_and_their_moments_hold_their_rows(run):
    full = {k: tuple(v.shape) for k, v in run["sd"].items()}
    n_split = 0
    for r in run["ranks"]:
        for k, (own, mu, nu) in r["shapes"].items():
            want = full[k]
            if tp.split_dim(k, want, N_MODEL) is not None:
                want = (want[0] // N_MODEL, *want[1:])
                n_split += 1
            assert own == mu == nu == want, k
    assert n_split > 40 * N_DATA * N_MODEL


def test_model_rank_forward_counts_its_share_of_the_split_flops(run):
    """On every rank: the matmul and convolution FLOPs that read split
    leaves at 1 / n_model of one process's, the others equal, and
    FlopCounterMode's total the sum of the two."""
    for r in run["ranks"]:
        (tot1, split1, other1), (totr, splitr, otherr) = (
            r["flops_one"], r["flops_rank"])
        assert split1 > 0.5 * tot1
        assert splitr * N_MODEL == split1
        assert otherr == other1
        assert (tot1, totr) == (split1 + other1, splitr + otherr)


# ---------------------------------------------------------- the replicas

def test_replicas_are_bit_equal(run):
    """After two steps: every replicated tensor (parameters, their Adam
    state, BatchNorm statistics, the cache) the same bits on all four
    ranks; a split leaf's the same on the data ranks of its model index.
    The metrics, averaged over the data ranks, the same on all four."""
    loc = [r["local"] for r in run["ranks"]]
    model_of = [r["mesh"][1] for r in run["ranks"]]
    assert sorted(r["mesh"] for r in run["ranks"]) == [
        (d, m) for d in range(N_DATA) for m in range(N_MODEL)]
    n_rep = n_split = 0
    for part in ("sd", "opt"):
        for k in loc[0][part]:
            name = k if part == "sd" else k.rsplit(".", 1)[0]
            split = (name in run["sd"] and tp.split_dim(
                name, run["sd"][name].shape, N_MODEL) is not None)
            for m in range(N_MODEL):
                peers = [r for r in range(len(loc))
                         if not split or model_of[r] == m]
                for r in peers[1:]:
                    assert torch.equal(loc[r][part][k],
                                       loc[peers[0]][part][k]), (r, k)
            n_split += split
            n_rep += not split
    assert n_rep > 100 and n_split > 100
    for r in range(1, len(loc)):
        assert torch.equal(loc[r]["cache"], loc[0]["cache"])
        assert torch.equal(loc[r]["valid"], loc[0]["valid"])
        for i in range(N_STEPS):
            assert (run["ranks"][r]["steps"][i]["metrics"]
                    == run["ranks"][0]["steps"][i]["metrics"])


# ------------------------------------------- one process, and refusals

def test_one_process_mesh_gives_the_bits_of_make_train_step():
    """The 1 x 1 mesh: no split, no group, make_train_step's bits."""
    m2 = tp.make_mesh_2d(1, 1, "cpu")
    assert (m2.data_group, m2.model_group) == (None, None)
    b = {k: torch.from_numpy(v) for k, v in global_batch(7).items()}
    draws = {"sel_idx": torch.zeros((G,), dtype=torch.int64)}
    outs = []
    for mode in ("tp", "plain"):
        state, sched = tiny_state(TCFG)
        if mode == "tp":
            state = tp.shard_state_tp(state, m2)
            step = tp.shard_train_step_tp(state, sched, m2, G)
        else:
            step = make_train_step(state.system, state.optimizer, sched, G)
        state, m = step(state, b, draws)
        outs.append((state.system.state_dict(), float(m["loss"])))
    assert outs[0][1] == outs[1][1]
    for k, v in outs[1][0].items():
        assert torch.equal(outs[0][0][k], v), k


def test_refuses_pallas_train():
    m2 = tp.make_mesh_2d(1, 1, "cpu")
    state, sched = tiny_state(TCFG, pallas_train=True)
    with pytest.raises(ValueError, match="pallas_train=False"):
        tp.shard_train_step_tp(state, sched, m2, G)


def test_refuses_a_world_that_is_not_the_mesh(monkeypatch):
    with pytest.raises(ValueError, match="needs 4 ranks, the world has 1"):
        tp.make_mesh_2d(2, 2, "cpu")
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "4")
    with pytest.raises(ValueError, match="needs 6 ranks, the world has 4"):
        tp.make_mesh_2d(3, 2, "cpu")


def test_refuses_grids_that_do_not_split_over_the_data_ranks():
    m2 = tp.Mesh2D(2, 1, 0, 0, None, None, torch.device("cpu"))
    state, sched = tiny_state(TCFG)
    with pytest.raises(ValueError, match="grids_per_step=3"):
        tp.shard_train_step_tp(state, sched, m2, 3)
