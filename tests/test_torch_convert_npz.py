"""The port's ``.npz`` parameter cache (``convert.load_network``,
``save_npz``, ``load_npz``, ``python -m drba_tpu_torch.convert_weights``)
against drba_tpu's (``drba_tpu/convert.py``, ``tools/convert_weights.py``).

A cache is ``drba_tpu``'s format, its JAX layouts, so one weights directory
serves both packages: every comparison of arrays here is bitwise in f32. The
windows at the end follow tests/test_torch_rife.py's tolerances.
"""

import importlib.util
import logging
import os
import shutil
import subprocess
import sys

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
from drba_tpu_torch.models import gmflow_net, gmfss_nets, ifnet
from drba_tpu_torch.models.rife import RIFE

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (name, drba_tpu's spec, the port's)
SPECS = {"ifnet": (jifnet.IFNET_SPEC, ifnet.IFNET_SPEC),
         "gmflow": (jgmflow.GMFLOW_SPEC, gmflow_net.GMFLOW_SPEC),
         "metricnet": (jnets.METRICNET_SPEC, gmfss_nets.METRICNET_SPEC),
         "featurenet": (jnets.FEATURENET_SPEC, gmfss_nets.FEATURENET_SPEC),
         "gridnet": (jnets.GRIDNET_SPEC, gmfss_nets.GRIDNET_SPEC),
         "gridnet_union": (jnets.GRIDNET_UNION_SPEC, gmfss_nets.GRIDNET_UNION_SPEC)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def port_warnings():
    """The port's log records (its logger does not propagate to the root)."""
    records = []

    class Keep(logging.Handler):
        def emit(self, record):
            records.append(record.getMessage())

    logger = logging.getLogger("drba_tpu_torch")
    h = Keep(logging.WARNING)
    logger.addHandler(h)
    yield records
    logger.removeHandler(h)


def assert_same_port_params(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == torch.float32 and got[k].shape == want[k].shape, k
        assert torch.equal(got[k], want[k]), k


def assert_same_arrays(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype == np.float32 and g.shape == w.shape, k
        np.testing.assert_array_equal(g, w, err_msg=k)


def _port_from_jax(params, spec):
    return convert.from_jax_params({k: np.asarray(v) for k, v in params.items()}, spec)


def test_npz_only_dir_gives_drba_tpus_params(tmp_path, port_warnings):
    """The fault: a weights dir holding only drba_tpu's ``save_npz`` output.
    The port reads it (before: "flownet.pkl not found; using random init")
    and carries drba_tpu's params after the layout change, bitwise."""
    jconvert.save_npz(str(tmp_path / "flownet.npz"), jax_init(jifnet.IFNET_SPEC, seed=7))
    want = jconvert.load_network(str(tmp_path), "flownet.pkl", jifnet.IFNET_SPEC)
    got = convert.load_network(str(tmp_path), "flownet.pkl", ifnet.IFNET_SPEC)
    assert_same_port_params(got, _port_from_jax(want, ifnet.IFNET_SPEC))
    assert not any("random init" in m for m in port_warnings), port_warnings
    seeded = convert.load_network(None, "flownet.pkl", ifnet.IFNET_SPEC)
    assert not torch.equal(got["block0.conv0.0.0.weight"], seeded["block0.conv0.0.0.weight"])


def test_npz_wins_over_pkl(tmp_path):
    spec = gmfss_nets.METRICNET_SPEC
    cached = _port_from_jax(jax_init(jnets.METRICNET_SPEC, seed=3), spec)
    other = _port_from_jax(jax_init(jnets.METRICNET_SPEC, seed=4), spec)
    torch.save(convert.to_torch_state_dict(other, spec), tmp_path / "metric.pkl")
    assert_same_port_params(convert.load_network(str(tmp_path), "metric.pkl", spec), other)
    convert.save_npz(str(tmp_path / "metric.npz"), cached, spec)
    assert_same_port_params(convert.load_network(str(tmp_path), "metric.pkl", spec), cached)
    # and drba_tpu reads the port's cache first as well
    assert_same_arrays(jconvert.load_network(str(tmp_path), "metric.pkl", jnets.METRICNET_SPEC),
                       jax_init(jnets.METRICNET_SPEC, seed=3))


@pytest.mark.parametrize("name", list(SPECS))
def test_each_packages_cache_reads_in_the_other(name, tmp_path):
    """Both ways, for each network's spec: the port's writer against
    drba_tpu's ``load_npz``, drba_tpu's writer against the port's reader."""
    jspec, spec = SPECS[name]
    assert list(jspec) == list(spec) and all(jspec[k] == spec[k] for k in spec)
    ref = jax_init(jspec, seed=11)
    port = _port_from_jax(ref, spec)

    convert.save_npz(str(tmp_path / "port.npz"), port, spec)
    assert_same_arrays(jconvert.load_npz(str(tmp_path / "port.npz")), ref)

    jconvert.save_npz(str(tmp_path / "jax.npz"), ref)
    assert_same_port_params(convert.load_npz(str(tmp_path / "jax.npz"), spec), port)


@pytest.mark.parametrize("name", list(SPECS))
def test_each_reference_pkl_loads_as_in_drba_tpu(name, tmp_path):
    """A reference-layout state dict of each network (``nn.Linear`` (O, I),
    ``nn.PReLU`` slopes (1,), ResConv betas (1, C, 1, 1)) through both
    packages' ``load_network``. The port raised on the GMFSS nets' PReLU
    slopes before (checkpoint shape () against the init's (1,))."""
    jspec, spec = SPECS[name]
    ref = jax_init(jspec, seed=13)
    state = convert.to_torch_state_dict(_port_from_jax(ref, spec), spec)
    for k, desc in spec.items():
        if desc[0] == "scalar":
            assert state[k].shape == (1,)
        elif k.endswith(".beta"):
            state[k] = state[k].reshape(1, -1, 1, 1)
    torch.save(state, tmp_path / "net.pkl")
    want = jconvert.load_network(str(tmp_path), "net.pkl", jspec, strict=True)
    assert_same_arrays(want, ref)
    got = convert.load_network(str(tmp_path), "net.pkl", spec, strict=True)
    assert_same_port_params(got, _port_from_jax(want, spec))


def _stand_in_tree(root, seed=21):
    """Reference-layout ``.pkl`` state dicts for some of the three models'
    networks: full, partial (keys missing: seed-0 init fills them), with
    ``module.`` prefixes, one already cached, the rest missing."""
    def state(spec, seed, drop=0, prefix=""):
        p = convert.from_jax_params(jax_init(spec, seed=seed), spec)
        sd = convert.to_torch_state_dict(p, spec)
        return {prefix + k: v for k, v in list(sd.items())[drop:]}

    rife = root / "train_log_rife_426_heavy"
    gmfss = root / "train_log_gmfss"
    union = root / "train_log_gmfss_union"
    for d in (rife, gmfss, union):
        d.mkdir(parents=True)
    torch.save(state(ifnet.IFNET_SPEC, seed), rife / "flownet.pkl")
    torch.save(state(gmfss_nets.METRICNET_SPEC, seed + 1, drop=3), gmfss / "metric.pkl")
    torch.save(state(gmfss_nets.FEATURENET_SPEC, seed + 2), gmfss / "feat.pkl")
    np.savez(gmfss / "feat.npz", marker=np.zeros(1, np.float32))  # cached: left alone
    torch.save(state(ifnet.IFNET_SPEC, seed + 3, prefix="module."), union / "rife.pkl")
    (root / "notes.txt").write_text("not a directory")


def _run_drba_tpu_tool(weights, monkeypatch, capsys):
    spec = importlib.util.spec_from_file_location(
        "convert_weights_tool", os.path.join(ROOT, "tools", "convert_weights.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    monkeypatch.setattr(sys, "argv", ["convert_weights.py", "--weights", str(weights)])
    capsys.readouterr()
    tool.main()
    return capsys.readouterr().out


def test_convert_weights_tool_writes_what_drba_tpus_tool_writes(tmp_path, monkeypatch, capsys):
    ours, theirs = tmp_path / "ours", tmp_path / "theirs"
    _stand_in_tree(ours)
    shutil.copytree(ours, theirs)
    got = subprocess.run([sys.executable, "-m", "drba_tpu_torch.convert_weights",
                          "--weights", str(ours)], cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert got.returncode == 0, got.stderr
    want = _run_drba_tpu_tool(theirs, monkeypatch, capsys)
    assert got.stdout.replace(str(ours), "ROOT") == want.replace(str(theirs), "ROOT")
    assert "done, 3 checkpoints converted" in got.stdout
    assert got.stdout.count("skip (missing)") == 6 and got.stdout.count("skip (cached)") == 1

    written = sorted(p.relative_to(ours) for p in ours.rglob("*.npz"))
    assert written == sorted(p.relative_to(theirs) for p in theirs.rglob("*.npz"))
    assert len(written) == 4
    for rel in written:
        with np.load(ours / rel) as a, np.load(theirs / rel) as b:
            assert_same_arrays(dict(a), dict(b))

    again = subprocess.run([sys.executable, "-m", "drba_tpu_torch.convert_weights",
                            "--weights", str(ours), "--force"], cwd=ROOT, capture_output=True,
                           text=True, timeout=300)
    assert again.returncode == 0 and "done, 4 checkpoints converted" in again.stdout


@pytest.mark.parametrize("fault", ["missing key", "shape", "extra key under strict"])
def test_a_bad_cache_raises_naming_file_and_key(fault, tmp_path):
    spec = gmfss_nets.METRICNET_SPEC
    arrays = jax_init(jnets.METRICNET_SPEC, seed=5)
    key = next(iter(spec))
    if fault == "missing key":
        del arrays[key]
    elif fault == "shape":
        arrays[key] = arrays[key][..., :1]
    else:
        arrays["stray.weight"] = np.zeros(2, np.float32)
    path = str(tmp_path / "metric.npz")
    np.savez(path, **arrays)
    with pytest.raises(ValueError) as e:
        convert.load_network(str(tmp_path), "metric.pkl", spec, strict=True)
    assert path in str(e.value)
    assert ("stray.weight" if fault.startswith("extra") else key) in str(e.value)


def test_extra_keys_are_dropped_with_a_warning_and_strict_needs_a_file(tmp_path, port_warnings):
    spec = gmfss_nets.METRICNET_SPEC
    arrays = jax_init(jnets.METRICNET_SPEC, seed=6)
    np.savez(tmp_path / "metric.npz", **arrays, **{"head.fold4.weight": np.ones(3, np.float32)})
    got = convert.load_network(str(tmp_path), "metric.pkl", spec)
    assert_same_port_params(got, _port_from_jax(arrays, spec))
    assert any("unexpected checkpoint keys ignored" in m for m in port_warnings)
    with pytest.raises(FileNotFoundError, match="not found"):
        convert.load_network(str(tmp_path), "feat.pkl", gmfss_nets.FEATURENET_SPEC, strict=True)


def assert_close_but_flips(got, want, atol, flip_share=5e-3, what=""):
    """As tests/test_torch_rife.py: a value tolerance, and at most
    ``flip_share`` of values beyond it (coverage thresholds can flip)."""
    d = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    share = float((d > atol).mean())
    assert share <= flip_share, f"{what}: {share:.2e} of values beyond {atol} (max {d.max():.3e})"


def _frames(n, h=64, w=128, step=3):
    base = np.random.default_rng(0).uniform(0, 1, (1, h, w + step * n, 3)).astype(np.float32)
    return [np.ascontiguousarray(base[:, :, step * i:step * i + w]) for i in range(n)]


def test_rife_from_an_npz_only_dir_matches_drba_tpus(tmp_path):
    """A RIFE f32 window at 64x128 built from an ``.npz``-only weights dir
    in both packages (tests/test_torch_rife.py's tolerances)."""
    jconvert.save_npz(str(tmp_path / "flownet.npz"), jax_init(jifnet.IFNET_SPEC, seed=9))
    jm = JaxRIFE(weights=str(tmp_path), config=JAX_F32)
    m = RIFE(weights=str(tmp_path), config=F32, device="cpu")
    fr = _frames(3)
    ts = [0.5, 1.0, 1.3]
    jo, jr = jm.inference_ts_drba(*(jnp.asarray(f) for f in fr), ts, None, linear=True)
    to, tr = m.inference_ts_drba(*(torch.from_numpy(f) for f in fr), ts, None, linear=True)
    assert len(to) == len(jo) == len(ts)
    for i, (g, w) in enumerate(zip(to, jo)):
        assert_close_but_flips(g, w, 1e-3, what=f"t={ts[i]}")
    for g, w in zip(tr, jr):
        assert_close_but_flips(g, w, 1e-4, what="reuse")
