#!/usr/bin/env python3
"""Convert the reference package's orbax segmentation checkpoint into the
port's .npz checkpoint.

    python scripts/convert_seg_ckpt.py [--src ventjax/models/seg_ckpt]
        [--out ventjax_torch/models/seg_ckpt.npz]

Runs where the reference package and orbax are installed: it reads the
checkpoint through ``ventjax.models.segmentation.load_checkpoint`` and
writes it with ``ventjax_torch.models.segmentation.save_checkpoint``,
params only (the checkpoint's step kept).  The one script outside the
tests that imports both packages; the port itself never imports this.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=os.path.join(REPO, "ventjax", "models",
                                                  "seg_ckpt"))
    ap.add_argument("--out", default=os.path.join(
        REPO, "ventjax_torch", "models", "seg_ckpt.npz"))
    args = ap.parse_args(argv)
    sys.path.insert(0, REPO)

    import jax

    jax.config.update("jax_platforms", "cpu")
    from ventjax.models.segmentation import load_checkpoint as jax_load
    from ventjax_torch.models.segmentation import (
        SegUNet, TrainState, base_of, params_from_flax, save_checkpoint,
    )

    src = jax_load(os.path.abspath(args.src))
    params = params_from_flax(jax.tree_util.tree_map(
        lambda a: jax.device_get(a), src.params))
    model = SegUNet(base=base_of(params))
    model.load_state_dict(params)
    path = save_checkpoint(args.out, TrainState(model, None,
                                                int(src.step)),
                           params_only=True)
    print(json.dumps({"checkpoint": path, "step": int(src.step),
                      "base": model.base, "parameters": sum(
                          p.numel() for p in model.parameters()),
                      "bytes": os.path.getsize(path)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
