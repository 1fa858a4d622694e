"""Weight conversion CLI (counterpart of `gsasr_tpu/cli/convert.py`): a
reference `.pth` pair (net_g and net_fea2gs, each `{'params': sd,
'params_ema': sd}`, `basicsr/models/base_model.py:208-253`) becomes one
step directory of the port's format (`gsasr_torch/utils/checkpoint.py`):

    <out>/<step>/net_g.pth       {'params': sd, 'params_ema': sd}
    <out>/<step>/net_fea2gs.pth  {'params': sd, 'params_ema': sd}

each state_dict loaded into the port's module first (a missing or
unexpected key raises) and written as the module holds it. `cli/infer.py
--ckpt_dir` and `path.pretrain_network_*` in the training options read it.

Usage:
  python -m gsasr_torch.cli.convert \\
      --enc_ckpt net_g_latest.pth --dec_ckpt net_fea2gs_latest.pth \\
      --model EDSR --version paper --out converted/edsr_paper [--step 0]
"""

from __future__ import annotations

import argparse

import torch


def convert_pair(enc_ckpt: str, dec_ckpt: str, model: str, version: str,
                 out: str, step: int = 0) -> str:
    """Convert both networks (params, and params_ema where the file has it,
    else params again) into one step directory (replacing an earlier one,
    as JAX's does). Returns the step directory's path."""
    from gsasr_torch.cli.infer import build_models
    from gsasr_torch.utils.checkpoint import load_torch_checkpoint, write_step
    from gsasr_torch.utils.convert import load_params

    enc, dec, enc_kind, dec_kind, _ = build_models(model, version,
                                                   device="cpu")
    files = {}
    for name, path, kind, mod in (("net_g", enc_ckpt, enc_kind, enc),
                                  ("net_fea2gs", dec_ckpt, dec_kind, dec)):
        blob = torch.load(path, map_location="cpu", weights_only=True)
        keys = [k for k in ("params", "params_ema")
                if isinstance(blob, dict) and k in blob] or ["params"]
        payload = {}
        for key in keys:
            load_params(mod, load_torch_checkpoint(path, kind, param_key=key))
            payload[key] = {k: v.clone() for k, v in mod.state_dict().items()}
        payload.setdefault("params_ema", payload["params"])
        files[name] = payload
    return str(write_step(out, step, files))


def main(argv=None) -> str:
    """Run the CLI on `argv` (default: the command line); returns the step
    directory's path."""
    from gsasr_torch.cli.infer import MODEL_ENCODERS

    p = argparse.ArgumentParser()
    p.add_argument("--enc_ckpt", required=True, help="reference net_g .pth")
    p.add_argument("--dec_ckpt", required=True,
                   help="reference net_fea2gs .pth")
    p.add_argument("--model", default="EDSR", choices=sorted(MODEL_ENCODERS))
    p.add_argument("--version", default="paper",
                   choices=["paper", "enhanced", "ultra"])
    p.add_argument("--out", required=True, help="output directory")
    p.add_argument("--step", type=int, default=0)
    args = p.parse_args(argv)

    path = convert_pair(args.enc_ckpt, args.dec_ckpt, args.model,
                        args.version, args.out, args.step)
    print(f"Converted -> {path}")
    print(f"Use with: python -m gsasr_torch.cli.infer --ckpt_dir {path} ...")
    return path


if __name__ == "__main__":
    main()
