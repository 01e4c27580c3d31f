"""The port's reference ``.pkl`` path (``convert.load_pickle`` through
``convert.load_network``) against drba_tpu's (``drba_tpu/convert.py``
``load_torch_pickle``), bitwise in f32, for the ten networks of the three
models' ``train_log_*`` directories:

- a partial state dict: the keys it lacks take the seed-0 init, whatever
  the network's seed, and the ``.npz`` that ``python -m
  drba_tpu_torch.convert_weights`` writes from it loads as the ``.pkl`` does;
- a state dict of numpy arrays (0-d slopes too), pickled under numpy 2's
  module names and under numpy 1's, read as data (``weights_only``);
- what the port refuses on purpose: any other global in a ``.pkl``, and,
  under ``strict``, an ``.npz`` with keys outside the spec (which drba_tpu
  loads).
"""

import io
import os
import pickle
import shutil
import subprocess
import sys
import zipfile
from fractions import Fraction

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from drba_tpu import convert as jconvert
from drba_tpu.config import F32 as JAX_F32
from drba_tpu.models import gmflow_net as jgmflow
from drba_tpu.models import gmfss_nets as jnets
from drba_tpu.models import ifnet as jifnet
from drba_tpu.models.layers import init_from_spec as jax_init
from drba_tpu.models.rife import RIFE as JaxRIFE
from drba_tpu_torch import convert
from drba_tpu_torch.config import F32
from drba_tpu_torch.convert_weights import specs_for
from drba_tpu_torch.models import gmflow_net, gmfss_nets, ifnet
from drba_tpu_torch.models.layers import init_from_spec
from drba_tpu_torch.models.rife import RIFE

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 5  # the models' config.seed: network i of a model loads at SEED + i

# the port's spec -> drba_tpu's, by name
JAX_SPECS = {id(ifnet.IFNET_SPEC): jifnet.IFNET_SPEC,
             id(gmflow_net.GMFLOW_SPEC): jgmflow.GMFLOW_SPEC,
             id(gmfss_nets.METRICNET_SPEC): jnets.METRICNET_SPEC,
             id(gmfss_nets.FEATURENET_SPEC): jnets.FEATURENET_SPEC,
             id(gmfss_nets.GRIDNET_SPEC): jnets.GRIDNET_SPEC,
             id(gmfss_nets.GRIDNET_UNION_SPEC): jnets.GRIDNET_UNION_SPEC}

# (train_log dir, .pkl name, the network's seed offset in its model)
NETS = [(sub, pkl, i)
        for sub in ("train_log_rife_426_heavy", "train_log_gmfss", "train_log_gmfss_union")
        for i, pkl in enumerate(specs_for(sub))]
NET_IDS = [f"{sub[len('train_log_'):]}/{pkl}" for sub, pkl, _ in NETS]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def assert_same_port_params(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == torch.float32 and got[k].shape == want[k].shape, k
        assert torch.equal(got[k], want[k]), k


def _port_from_jax(params, spec):
    return convert.from_jax_params({k: np.asarray(v) for k, v in params.items()}, spec)


def _dropped(j):
    return j < 3 or j % 7 == 0


def _partial_state(spec, seed):
    """A reference-layout state dict without its first three keys and every
    seventh after them."""
    sd = convert.to_torch_state_dict(convert.from_jax_params(init_from_spec(spec, seed), spec),
                                     spec)
    return {k: v for j, (k, v) in enumerate(sd.items()) if not _dropped(j)}


@pytest.mark.parametrize("sub,pkl,i", NETS, ids=NET_IDS)
def test_a_partial_pkl_fills_at_seed_0_as_drba_tpu(sub, pkl, i, tmp_path):
    """Before the fix the port filled the missing keys at the network's
    seed (MetricNet at seed 1: ``metric_in.weight`` off by up to 0.1768)."""
    spec = specs_for(sub)[pkl]
    jspec = JAX_SPECS[id(spec)]
    torch.save(_partial_state(spec, seed=40 + i), tmp_path / pkl)
    want = jconvert.load_network(str(tmp_path), pkl, jspec, seed=SEED + i)
    got = convert.load_network(str(tmp_path), pkl, spec, seed=SEED + i)
    assert_same_port_params(got, _port_from_jax(want, spec))
    filled = _port_from_jax(jax_init(jspec, seed=0), spec)
    # a dropped random weight (slopes and norms draw nothing)
    first = next(k for j, k in enumerate(spec)
                 if _dropped(j) and spec[k][0] in ("conv", "convT", "linear"))
    assert torch.equal(got[first], filled[first])
    # with no file the network's own seed stays, in both packages
    seeded = convert.load_network(str(tmp_path / "none"), pkl, spec, seed=SEED + i)
    assert_same_port_params(seeded, _port_from_jax(jax_init(jspec, seed=SEED + i), spec))
    assert not torch.equal(seeded[first], got[first])


@pytest.fixture(scope="module")
def converted_tree(tmp_path_factory):
    """Partial ``.pkl`` files of all ten networks, and the ``.npz`` that
    ``python -m drba_tpu_torch.convert_weights`` writes from each, in two
    trees of their own."""
    root = tmp_path_factory.mktemp("weights")
    made, pkls, npzs = root / "made", root / "pkl", root / "npz"
    for sub, pkl, i in NETS:
        (made / sub).mkdir(parents=True, exist_ok=True)
        torch.save(_partial_state(specs_for(sub)[pkl], seed=60 + 10 * i + len(sub)),
                   made / sub / pkl)
    got = subprocess.run([sys.executable, "-m", "drba_tpu_torch.convert_weights",
                          "--weights", str(made)], cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert got.returncode == 0, got.stderr
    assert f"done, {len(NETS)} checkpoints converted" in got.stdout
    for tree, ext in ((pkls, ".pkl"), (npzs, ".npz")):
        for sub, pkl, _ in NETS:
            (tree / sub).mkdir(parents=True, exist_ok=True)
            name = os.path.splitext(pkl)[0] + ext
            shutil.copy(made / sub / name, tree / sub / name)
    return pkls, npzs


@pytest.mark.parametrize("sub,pkl,i", NETS, ids=NET_IDS)
def test_a_partial_pkl_loads_as_the_npz_converted_from_it(sub, pkl, i, converted_tree):
    """Before the fix the converter filled at seed 0 and ``load_network`` at
    the network's seed, so the two disagreed."""
    pkls, npzs = converted_tree
    spec = specs_for(sub)[pkl]
    from_pkl = convert.load_network(str(pkls / sub), pkl, spec, seed=SEED + i)
    from_npz = convert.load_network(str(npzs / sub), pkl, spec, seed=SEED + i)
    assert_same_port_params(from_pkl, from_npz)
    assert_same_port_params(
        from_npz, _port_from_jax(jconvert.load_network(str(npzs / sub), pkl,
                                                       JAX_SPECS[id(spec)]), spec))


def _respell(path, module):
    """Rewrite a ``torch.save`` file so that its pickle names numpy's
    multiarray module as ``module`` (numpy 1: ``numpy.core.multiarray``,
    numpy 2: ``numpy._core.multiarray``), whichever numpy wrote it."""
    with zipfile.ZipFile(path) as z:
        records = {n: z.read(n) for n in z.namelist()}
    for n, b in records.items():
        if n.endswith("/data.pkl"):
            for old in (b"numpy._core.multiarray", b"numpy.core.multiarray"):
                b = b.replace(old + b"\n", module.encode() + b"\n")
            assert module.encode() + b"\n" in b
            records[n] = b
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_STORED) as z:
        for n, b in records.items():
            z.writestr(n, b)
    path.write_bytes(buf.getvalue())


def _ndarray_state(spec, seed):
    """A reference-layout state dict of numpy arrays: ResConv betas
    (1, C, 1, 1), and PReLU slopes in turn a numpy scalar, a 0-d array and
    a (1,) array."""
    sd = convert.to_torch_state_dict(convert.from_jax_params(init_from_spec(spec, seed), spec),
                                     spec)
    out, n_scalar = {}, 0
    for k, v in sd.items():
        v = v.numpy()
        if spec[k][0] == "scalar":
            v = (np.float32(v[0]), np.array(v[0], np.float32), v)[n_scalar % 3]
            n_scalar += 1
        elif k.endswith(".beta"):
            v = v.reshape(1, -1, 1, 1)
        out["module." + k] = v
    return out


SPEC_NAMES = {"ifnet": ifnet.IFNET_SPEC, "gmflow": gmflow_net.GMFLOW_SPEC,
              "metricnet": gmfss_nets.METRICNET_SPEC,
              "featurenet": gmfss_nets.FEATURENET_SPEC, "gridnet": gmfss_nets.GRIDNET_SPEC,
              "gridnet_union": gmfss_nets.GRIDNET_UNION_SPEC}


@pytest.mark.parametrize("module", ["numpy._core.multiarray", "numpy.core.multiarray"])
@pytest.mark.parametrize("name", list(SPEC_NAMES))
def test_an_ndarray_state_dict_loads_as_in_drba_tpu(name, module, tmp_path):
    """Before the fix the port's ``weights_only`` load raised
    ``UnpicklingError`` on numpy's globals; drba_tpu reads such a file."""
    spec = SPEC_NAMES[name]
    state = _ndarray_state(spec, seed=17)
    if any(d[0] == "scalar" for d in spec.values()):
        assert any(isinstance(v, np.generic) for v in state.values())
        assert any(isinstance(v, np.ndarray) and v.ndim == 0 for v in state.values())
    torch.save(state, tmp_path / "net.pkl")
    _respell(tmp_path / "net.pkl", module)
    assert module in " ".join(torch.serialization.get_unsafe_globals_in_checkpoint(
        tmp_path / "net.pkl"))
    want = jconvert.load_network(str(tmp_path), "net.pkl", JAX_SPECS[id(spec)], strict=True)
    got = convert.load_network(str(tmp_path), "net.pkl", spec, seed=SEED, strict=True)
    assert_same_port_params(got, _port_from_jax(want, spec))
    # and as its tensor twin loads
    twin = {k: torch.from_numpy(np.array(v)) for k, v in state.items()}
    torch.save(twin, tmp_path / "twin.pkl")
    assert_same_port_params(got, convert.load_network(str(tmp_path), "twin.pkl", spec,
                                                      strict=True))


@pytest.mark.parametrize("stray,global_name", [
    (Fraction(1, 3), "fractions.Fraction"),
    (np.random.default_rng(0), "numpy.random._pickle.__generator_ctor"),
], ids=["fraction", "numpy_generator"])
def test_a_pkl_naming_another_global_is_refused(stray, global_name, tmp_path):
    """Only tensors and numpy's arrays, scalars and dtypes are read from a
    ``.pkl``; drba_tpu unpickles anything (``weights_only=False``), the port
    refuses it and names the global (``ROADMAP.md`` Queue 3)."""
    spec = gmfss_nets.METRICNET_SPEC
    state = _ndarray_state(spec, seed=18)
    state["stray"] = stray
    torch.save(state, tmp_path / "metric.pkl")
    with pytest.raises(pickle.UnpicklingError) as e:
        convert.load_network(str(tmp_path), "metric.pkl", spec)
    assert global_name in str(e.value) and str(tmp_path / "metric.pkl") in str(e.value)
    # the arrays beside it are not what is refused
    assert not any(g in str(e.value) for g in ("_reconstruct", "multiarray.scalar",
                                                "numpy.ndarray", "numpy.dtype"))


def test_a_strict_npz_with_extra_keys_loads_in_drba_tpu_and_raises_in_the_port(tmp_path):
    """A gap in the reference, kept on purpose (``ROADMAP.md`` Queue 3):
    drba_tpu's ``.npz`` path ignores ``strict``, whose help says it fails on
    keys that do not match; the port refuses the file."""
    arrays = jax_init(jnets.METRICNET_SPEC, seed=19)
    np.savez(tmp_path / "metric.npz", **arrays, stray=np.zeros(2, np.float32))
    want = jconvert.load_network(str(tmp_path), "metric.pkl", jnets.METRICNET_SPEC,
                                 strict=True)
    assert "stray" in want
    with pytest.raises(ValueError, match="strict load failed.*stray"):
        convert.load_network(str(tmp_path), "metric.pkl", gmfss_nets.METRICNET_SPEC,
                             strict=True)
    got = convert.load_network(str(tmp_path), "metric.pkl", gmfss_nets.METRICNET_SPEC)
    assert_same_port_params(got, _port_from_jax(arrays, gmfss_nets.METRICNET_SPEC))


def _frames(n, h=64, w=128, step=3):
    base = np.random.default_rng(0).uniform(0, 1, (1, h, w + step * n, 3)).astype(np.float32)
    return [np.ascontiguousarray(base[:, :, step * i:step * i + w]) for i in range(n)]


def test_rife_from_a_partial_pkl_at_seed_3_matches_drba_tpus(tmp_path):
    """The slice: a RIFE f32 window at 64x128 built in both packages at
    ``config.seed = 3`` from a ``.pkl`` that lacks keys (the seed-0 fill),
    at tests/test_torch_rife.py's tolerances."""
    torch.save(_partial_state(ifnet.IFNET_SPEC, seed=23), tmp_path / "flownet.pkl")
    jm = JaxRIFE(weights=str(tmp_path), config=JAX_F32.replace(seed=3))
    m = RIFE(weights=str(tmp_path), config=F32.replace(seed=3), device="cpu")
    fr = _frames(3)
    ts = [0.5, 1.0, 1.3]
    jo, jr = jm.inference_ts_drba(*(jnp.asarray(f) for f in fr), ts, None, linear=True)
    to, tr = m.inference_ts_drba(*(torch.from_numpy(f) for f in fr), ts, None, linear=True)
    assert len(to) == len(jo) == len(ts)
    for i, (g, w) in enumerate(zip(to, jo)):
        d = np.abs(np.asarray(g, np.float64) - np.asarray(w, np.float64))
        assert float((d > 1e-3).mean()) <= 5e-3, f"t={ts[i]}: max {d.max():.3e}"
    for g, w in zip(tr, jr):
        d = np.abs(np.asarray(g, np.float64) - np.asarray(w, np.float64))
        assert float((d > 1e-4).mean()) <= 5e-3, f"reuse: max {d.max():.3e}"
