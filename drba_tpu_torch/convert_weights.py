"""Convert reference torch ``.pkl`` checkpoints to ``.npz`` parameter caches.

Usage:
  python -m drba_tpu_torch.convert_weights --weights weights/ [--force]

Counterpart of tools/convert_weights.py: scans the three ``train_log_*``
directories (the reference layout, infer.py:43-51) and writes a ``.npz`` next
to each ``.pkl`` of a network it knows, in ``drba_tpu``'s JAX layout (the same
keys and arrays as that tool writes from the same ``.pkl``). Both packages'
``load_network`` read the ``.npz`` before the ``.pkl``, so after converting
the ``.pkl`` may go.
"""

from __future__ import annotations

import argparse
import os

from drba_tpu_torch.convert import load_pickle, save_npz


def specs_for(dirname: str) -> dict:
    """The networks of a ``train_log_*`` directory: ``.pkl`` name -> spec."""
    from drba_tpu_torch.models.gmflow_net import GMFLOW_SPEC
    from drba_tpu_torch.models.gmfss_nets import (
        FEATURENET_SPEC,
        GRIDNET_SPEC,
        GRIDNET_UNION_SPEC,
        METRICNET_SPEC,
    )
    from drba_tpu_torch.models.ifnet import IFNET_SPEC

    if dirname.endswith("rife_426_heavy"):
        return {"flownet.pkl": IFNET_SPEC}
    if dirname.endswith("gmfss_union"):
        return {"flownet.pkl": GMFLOW_SPEC, "metric.pkl": METRICNET_SPEC,
                "feat.pkl": FEATURENET_SPEC, "fusionnet.pkl": GRIDNET_UNION_SPEC,
                "rife.pkl": IFNET_SPEC}
    if dirname.endswith("gmfss"):
        return {"flownet.pkl": GMFLOW_SPEC, "metric.pkl": METRICNET_SPEC,
                "feat.pkl": FEATURENET_SPEC, "fusionnet.pkl": GRIDNET_SPEC}
    return {}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--weights", default="weights", help="weights root directory")
    ap.add_argument("--force", action="store_true", help="overwrite existing .npz")
    args = ap.parse_args(argv)

    converted = 0
    for sub in sorted(os.listdir(args.weights)):
        d = os.path.join(args.weights, sub)
        if not os.path.isdir(d):
            continue
        for pkl, spec in specs_for(sub).items():
            src = os.path.join(d, pkl)
            dst = os.path.splitext(src)[0] + ".npz"
            if not os.path.exists(src):
                print(f"skip (missing): {src}")
                continue
            if os.path.exists(dst) and not args.force:
                print(f"skip (cached):  {dst}")
                continue
            params = load_pickle(src, spec)
            save_npz(dst, params, spec)
            print(f"converted:      {src} -> {dst} ({len(params)} tensors)")
            converted += 1
    print(f"done, {converted} checkpoints converted")
    return converted


if __name__ == "__main__":
    main()
