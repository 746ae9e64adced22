"""Export a JAX transducer checkpoint as a state dict for the PyTorch port.

Restores an orbax tree with the JAX package's ``Transducer.load_checkpoint``,
converts it with ``amira_rust_asr_server_tpu_torch.convert.from_jax_params``
and writes an ``.npz`` that the port loads with ``load_npz`` (or serves via
``checkpoint_path``). Needs jax and orbax; the port itself needs neither.

    python tools/export_torch_params.py \
        --checkpoint model-repo/tiny-digits --preset tiny \
        --out amira_rust_asr_server_tpu_torch/assets/tiny_digits.npz
"""

from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))


def export(checkpoint: str, preset: str, out: str) -> int:
    import jax

    from amira_rust_asr_server_tpu.models import Transducer
    from amira_rust_asr_server_tpu_torch.convert import (from_jax_params,
                                                         save_npz)
    from amira_rust_asr_server_tpu_torch.models import Transducer as Torch

    model = Transducer.from_preset(preset)
    params = jax.device_get(model.load_checkpoint(checkpoint))
    state = from_jax_params(params, model.config)
    Torch(model.config).load_state_dict(state)  # strict: every key, shape
    save_npz(out, state)
    return sum(v.numel() for v in state.values())


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--checkpoint", default=str(REPO / "model-repo" /
                                               "tiny-digits"))
    p.add_argument("--preset", default="tiny")
    p.add_argument("--out", default=str(
        REPO / "amira_rust_asr_server_tpu_torch" / "assets" /
        "tiny_digits.npz"))
    args = p.parse_args(argv)
    n = export(args.checkpoint, args.preset, args.out)
    print(f"wrote {args.out}: {n} params, {os.path.getsize(args.out)} bytes")


if __name__ == "__main__":
    main()
