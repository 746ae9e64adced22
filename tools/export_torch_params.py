"""Export a JAX checkpoint as a state dict for the PyTorch port.

Restores an orbax tree with the JAX package's model class of the family
(``Transducer``, ``CTCModel`` or ``AEDModel``) ``load_checkpoint``, converts
it with ``amira_rust_asr_server_tpu_torch.convert.from_jax_params``, loads it
strictly into the port's model of the family (every key and shape) and
writes an ``.npz`` that the port loads with ``load_npz`` (or serves via
``checkpoint_path``). Needs jax and orbax; the port itself needs neither.

    python tools/export_torch_params.py --family transducer   # tiny-digits
    python tools/export_torch_params.py --family ctc           # -ctc
    python tools/export_torch_params.py --family aed           # -aed

Without ``--checkpoint``/``--out`` a family reads ``model-repo/tiny-digits``
(``-ctc``, ``-aed``) and writes ``amira_rust_asr_server_tpu_torch/assets/
tiny_digits.npz`` (``tiny_digits_ctc.npz``, ``tiny_digits_aed.npz``).
"""

from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

SUFFIX = {"transducer": "", "ctc": "-ctc", "aed": "-aed"}


def default_paths(family: str):
    """(orbax tree, .npz) of the committed tiny-digits weights of a family."""
    ckpt = REPO / "model-repo" / f"tiny-digits{SUFFIX[family]}"
    out = (REPO / "amira_rust_asr_server_tpu_torch" / "assets"
           / f"tiny_digits{SUFFIX[family].replace('-', '_')}.npz")
    return ckpt, out


def jax_model(family: str, preset: str):
    if family == "ctc":
        from amira_rust_asr_server_tpu.models.ctc import CTCModel
        return CTCModel.from_preset(preset)
    if family == "aed":
        from amira_rust_asr_server_tpu.models.aed import AEDModel
        return AEDModel.from_preset(preset)
    from amira_rust_asr_server_tpu.models import Transducer
    return Transducer.from_preset(preset)


def export(checkpoint: str, preset: str, out: str,
           family: str = "transducer") -> int:
    import jax

    from amira_rust_asr_server_tpu_torch.convert import (from_jax_params,
                                                         save_npz, to_model)

    model = jax_model(family, preset)
    params = jax.device_get(model.load_checkpoint(checkpoint))
    state = from_jax_params(params, model.config, family)
    to_model(params, model.config, family)  # strict: every key, shape
    save_npz(out, state)
    return sum(v.numel() for v in state.values())


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--family", choices=list(SUFFIX), default="transducer")
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--preset", default="tiny")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    ckpt, out = default_paths(args.family)
    ckpt, out = args.checkpoint or str(ckpt), args.out or str(out)
    n = export(ckpt, args.preset, out, args.family)
    print(f"wrote {out}: {n} params, {os.path.getsize(out)} bytes")


if __name__ == "__main__":
    main()
