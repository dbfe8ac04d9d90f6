"""The JAX package's flax params (as numpy) -> the port's state dicts.

- ``rrdbnet_from_jax_params``: ``visiondepth3d_tpu.enhance.esrgan.RRDBNet``
  params -> a state dict for ``enhance.esrgan.RRDBNet`` (Real-ESRGAN names).
- ``ifnet_from_jax_params``: ``visiondepth3d_tpu.enhance.rife.IFNet`` params
  -> a state dict for ``enhance.rife.IFNet`` (practical-RIFE names).

Conv kernels go HWIO -> OIHW; the transpose conv's flax kernel
(kh, kw, out, in) (``transpose_kernel=True``) goes to torch's
ConvTranspose2d layout (in, out, kh, kw), the inverse of
``visiondepth3d_tpu/enhance/rife.py:convert_rife``.
"""

from __future__ import annotations

import numpy as np
import torch

from .rife import IFNetConfig


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _conv(sd: dict, prefix: str, p: dict):
    sd[f"{prefix}.weight"] = _t(np.asarray(p["kernel"]).transpose(3, 2, 0, 1))
    sd[f"{prefix}.bias"] = _t(p["bias"])


def rrdbnet_from_jax_params(params: dict) -> dict[str, torch.Tensor]:
    sd: dict[str, torch.Tensor] = {}
    for name, p in params.items():
        if name.startswith("body"):
            i = int(name[4:])
            for rdb, convs in p.items():
                for conv, cp in convs.items():
                    _conv(sd, f"body.{i}.{rdb}.{conv}", cp)
        else:
            _conv(sd, name, p)
    return sd


def ifnet_from_jax_params(params: dict, cfg: IFNetConfig) -> dict[str, torch.Tensor]:
    sd: dict[str, torch.Tensor] = {}

    def conv_prelu(prefix, p):
        _conv(sd, f"{prefix}.0", p["conv"])
        sd[f"{prefix}.1.weight"] = _t(p["prelu"]["alpha"])

    for i in range(len(cfg.cs)):
        b, blk = f"block{i}", params[f"block{i}"]
        conv_prelu(f"{b}.conv0.0", blk["down0"])
        conv_prelu(f"{b}.conv0.1", blk["down1"])
        for k in range(cfg.n_res):
            r, rp = f"{b}.convblock.{k}", blk[f"res{k}"]
            if cfg.res_prelu:
                conv_prelu(f"{r}.conv", rp["conv"])
            else:
                _conv(sd, f"{r}.conv", rp["conv"])
            sd[f"{r}.beta"] = _t(rp["beta"]).reshape(1, -1, 1, 1)
        sd[f"{b}.lastconv.0.weight"] = _t(
            np.asarray(blk["lastconv"]["kernel"]).transpose(3, 2, 0, 1))
        sd[f"{b}.lastconv.0.bias"] = _t(blk["lastconv"]["bias"])
    return sd
