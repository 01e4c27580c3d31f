"""The port's model API is written once (drba_tpu_torch/models/base.py).

Each model class keeps only its weights and its eager bodies, and says
whether its plain call hands a pass on; the graph cache below the models
imports neither the models nor the multi-device planner.
"""

import json
import os
import subprocess
import sys

import pytest

from drba_tpu_torch.models.base import Model
from drba_tpu_torch.models.gmfss import GMFSS
from drba_tpu_torch.models.gmfss_union import GMFSS_UNION
from drba_tpu_torch.models.rife import RIFE

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
API = {"inference_ts", "inference_ts_drba", "next_reuse", "drba_window", "reuse",
       "_fused_window", "_routed_pass", "_route", "_ts"}
OWN = {"__init__", "_pass", "_plain", "_window", "PLAIN_PASS", "PARAM_TREES"}


@pytest.mark.parametrize("cls,plain_pass,trees", [
    (RIFE, False, ("params",)), (GMFSS, True, ("params",)),
    (GMFSS_UNION, True, ("params", "rife_params"))], ids=["rife", "gmfss", "gmfss_union"])
def test_each_model_keeps_only_its_own_parts(cls, plain_pass, trees):
    """The calls and their routing are the base class's; a model defines
    only its weights, its three eager bodies and its constants, and its
    plain call hands a pass on (what the frame loop chains on) only in the
    GMFSS pair."""
    assert issubclass(cls, Model)
    own = {k for k in vars(cls) if not (k.startswith("__") and k != "__init__")}
    assert not own & API, own & API
    assert own <= OWN, own - OWN
    assert cls.PLAIN_PASS is plain_pass and cls.PARAM_TREES == trees


def test_the_graph_cache_loads_neither_the_models_nor_the_planner():
    """In a fresh process: importing ``graphs`` loads no model module, and
    importing it and the three models loads no ``parallel`` module."""
    code = ("import json, sys\n"
            "def loaded(prefix):\n"
            "    return sorted(m for m in sys.modules if m.startswith(prefix))\n"
            "import drba_tpu_torch.graphs\n"
            "below = loaded('drba_tpu_torch.models') + loaded('drba_tpu_torch.parallel')\n"
            "import drba_tpu_torch.models.rife, drba_tpu_torch.models.gmfss\n"
            "import drba_tpu_torch.models.gmfss_union\n"
            "print(json.dumps([below, loaded('drba_tpu_torch.parallel')]))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=ROOT,
                         timeout=300, env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr[-2000:]
    below, planner = json.loads(out.stdout.strip().splitlines()[-1])
    assert below == [] and planner == []
