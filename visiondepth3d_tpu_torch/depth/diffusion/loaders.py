"""Checkpoint-directory loaders of the diffusion depth pipelines.

Counterpart of ``visiondepth3d_tpu/depth/diffusion/loaders.py``. The
directories are diffusers' layout, one folder per component::

    marigold/                          depthcrafter/
      unet/config.json                   unet/config.json
      unet/diffusion_pytorch_model...    unet/diffusion_pytorch_model...
      vae/config.json                    vae/...
      vae/diffusion_pytorch_model...     image_encoder/config.json
      empty_text_embed.npy (optional)    image_encoder/model.safetensors

or a component's safetensors and ``<name>_config.json`` flat in the
directory (the reference's ``weights/DepthCrafter``: the UNet's
``diffusion_pytorch_model.safetensors`` and ``unet_config.json`` at the
root). The weights load under their diffusers (and transformers) names,
as they are. ``empty_text_embed.npy`` is the CLIP text embedding of the
empty prompt ([1, 77, cross dim]); without it Marigold's context is zeros,
with a warning.
"""

from __future__ import annotations

import dataclasses
import json
import os
import warnings

import numpy as np
import torch
from torch import nn

from ...device import DEFAULT_DEVICE
from ..convert import load_safetensors
from ..model import init_random_fan_in_
from .clip_vision import CLIP_TINY, CLIPVisionConfig, CLIPVisionEncoder
from .depthcrafter import DepthCrafterPipeline
from .marigold import MarigoldPipeline
from .unet2d import UNET2D_TINY, UNet2DCondition, UNet2DConfig
from .unet_st import UNET_ST_TINY, AlphaBlender, UNetSpatioTemporal, UNetSTConfig
from .vae import VAE_TINY, AutoencoderKL, VAEConfig, identity_quant_convs

_FILENAMES = ("diffusion_pytorch_model.safetensors", "model.safetensors")


def _load_component(root, name: str) -> tuple[dict, dict]:
    """(state dict, config dict) of ``root/name``, or of the flat layout."""
    candidates = [(os.path.join(root, name, fn), os.path.join(root, name, "config.json"))
                  for fn in _FILENAMES]
    candidates += [(os.path.join(root, fn), os.path.join(root, f"{name}_config.json"))
                   for fn in _FILENAMES]
    for state_path, cfg_path in candidates:
        if os.path.exists(state_path):
            cfg = {}
            if os.path.exists(cfg_path):
                with open(cfg_path) as f:
                    cfg = json.load(f)
            return load_safetensors(state_path), cfg
    raise FileNotFoundError(f"no {name} checkpoint under {str(root)!r} (looked for "
                            f"{_FILENAMES} in '{name}/' and the directory root)")


def _config(cfg: dict, cls):
    """A diffusers config.json -> our dataclass (``norm_num_groups`` is
    ``norm_groups``; ``down_block_types`` says which blocks attend; a single
    ``attention_head_dim`` holds for every block)."""
    if "norm_num_groups" in cfg and "norm_groups" not in cfg:
        cfg = dict(cfg, norm_groups=cfg["norm_num_groups"])
    out = cls()
    fields = {f.name for f in dataclasses.fields(cls)}
    kw = {k: tuple(v) if isinstance(v, list) else v for k, v in cfg.items() if k in fields}
    if "attention_head_dim" in kw and not isinstance(kw["attention_head_dim"], tuple):
        kw["attention_head_dim"] = (kw["attention_head_dim"],) * len(
            kw.get("block_out_channels", out.block_out_channels))
    if cfg.get("down_block_types") and "with_attn" in fields:
        kw["with_attn"] = tuple("CrossAttn" in t for t in cfg["down_block_types"])
    return dataclasses.replace(out, **kw)


def _clip_config(cfg: dict) -> CLIPVisionConfig:
    """transformers' ``CLIPVisionConfig`` json -> our config."""
    return CLIPVisionConfig(hidden_size=cfg.get("hidden_size", 1280),
                            num_layers=cfg.get("num_hidden_layers", 32),
                            num_heads=cfg.get("num_attention_heads", 16),
                            patch_size=cfg.get("patch_size", 14),
                            image_size=cfg.get("image_size", 224),
                            projection_dim=cfg.get("projection_dim", 1024))


def load_diffusers_state(model: nn.Module, state: dict) -> nn.Module:
    """A diffusers-named state dict into the port's UNet or VAE. Linear
    weights stored as 1x1 convs (older checkpoints) are squeezed; every
    model parameter must be present; keys the port does not hold are left."""
    own = model.state_dict()
    fixed = {}
    for k, v in state.items():
        v = torch.as_tensor(np.asarray(v)) if not isinstance(v, torch.Tensor) else v
        if k in own and v.ndim == 4 and own[k].ndim == 2:
            v = v[:, :, 0, 0]
        fixed[k] = v.to(torch.float32)
    missing, _ = model.load_state_dict({k: v for k, v in fixed.items() if k in own},
                                       strict=False)
    if missing:
        raise KeyError(f"checkpoint does not fit the {type(model).__name__}: missing {missing}")
    return model


def build_random_marigold(seed: int = 0, unet_cfg: UNet2DConfig = UNet2DConfig(),
                          vae_cfg: VAEConfig = VAEConfig(), steps: int = 4,
                          ensemble: int = 1, dtype: str = "float32", device=DEFAULT_DEVICE,
                          context_tokens: int = 77) -> MarigoldPipeline:
    """A Marigold pipeline with seeded random weights (the published widths
    unless configs are given) and a zero text context; shape and speed
    testing only."""
    gen = torch.Generator().manual_seed(seed)
    with torch.device("meta"):  # every parameter is drawn below: skip the default init
        unet, vae = UNet2DCondition(unet_cfg), AutoencoderKL(vae_cfg)
    unet = init_random_fan_in_(unet.to_empty(device="cpu"), gen)
    vae = init_random_fan_in_(vae.to_empty(device="cpu"), gen)
    ctx = np.zeros((1, context_tokens, unet_cfg.cross_attention_dim), np.float32)
    return MarigoldPipeline(unet, vae, ctx, num_steps=steps, ensemble_size=ensemble,
                            dtype=dtype, device=device)


def tiny_marigold(seed: int = 0, steps: int = 2, dtype: str = "float32",
                  device=DEFAULT_DEVICE) -> MarigoldPipeline:
    """The JAX package's tiny random-weight pipeline (UNET2D_TINY, VAE_TINY,
    a 7-token zero context): what ``allow_random`` loads."""
    return build_random_marigold(seed, UNET2D_TINY, VAE_TINY, steps=steps, dtype=dtype,
                                 device=device, context_tokens=7)


def build_random_depthcrafter(seed: int = 0, unet_cfg: UNetSTConfig = UNetSTConfig(),
                              vae_cfg: VAEConfig = VAEConfig(),
                              clip_cfg: CLIPVisionConfig = CLIPVisionConfig(), steps: int = 2,
                              window: int = 24, overlap: int = 6, dtype: str = "float32",
                              device=DEFAULT_DEVICE) -> DepthCrafterPipeline:
    """A DepthCrafter pipeline with seeded random weights (the published
    widths unless configs are given: 1.99 B parameters, the ST-UNet without
    the parts the JAX package drops); the mix factors start at flax's 0.5.
    Shape and speed testing only."""
    gen = torch.Generator().manual_seed(seed)
    with torch.device("meta"):  # every parameter is drawn below: skip the default init
        mods = UNetSpatioTemporal(unet_cfg), AutoencoderKL(vae_cfg), CLIPVisionEncoder(clip_cfg)
    unet, vae, clip = (init_random_fan_in_(m.to_empty(device="cpu"), gen) for m in mods)
    with torch.no_grad():
        for m in unet.modules():
            if isinstance(m, AlphaBlender):
                m.mix_factor.fill_(0.5)
    return DepthCrafterPipeline(unet, vae, clip, num_steps=steps, window_size=window,
                                overlap=overlap, dtype=dtype, device=device)


def tiny_depthcrafter(seed: int = 0, steps: int = 2, window: int = 6, overlap: int = 2,
                      dtype: str = "float32", device=DEFAULT_DEVICE) -> DepthCrafterPipeline:
    """The JAX package's tiny random-weight pipeline (UNET_ST_TINY, VAE_TINY,
    CLIP_TINY projecting to the UNet's cross dim): what ``allow_random``
    loads."""
    clip = dataclasses.replace(CLIP_TINY, projection_dim=UNET_ST_TINY.cross_attention_dim)
    return build_random_depthcrafter(seed, UNET_ST_TINY, VAE_TINY, clip, steps=steps,
                                     window=window, overlap=overlap, dtype=dtype, device=device)


def load_depthcrafter(checkpoint_dir, steps: int = 2, window: int = 24, overlap: int = 6,
                      dtype: str = "float32", device=DEFAULT_DEVICE) -> DepthCrafterPipeline:
    unet_state, unet_cfg_d = _load_component(checkpoint_dir, "unet")
    vae_state, vae_cfg_d = _load_component(checkpoint_dir, "vae")
    clip_state, clip_cfg_d = _load_component(checkpoint_dir, "image_encoder")
    vae_cfg = _config(vae_cfg_d, VAEConfig)
    unet = load_diffusers_state(UNetSpatioTemporal(_config(unet_cfg_d, UNetSTConfig)),
                                unet_state)
    vae = load_diffusers_state(AutoencoderKL(vae_cfg),
                               identity_quant_convs(vae_state, vae_cfg.latent_channels))
    clip = load_diffusers_state(CLIPVisionEncoder(_clip_config(clip_cfg_d)), clip_state)
    return DepthCrafterPipeline(unet, vae, clip, num_steps=steps, window_size=window,
                                overlap=overlap, dtype=dtype, device=device)


def load_marigold(checkpoint_dir, steps: int = 4, ensemble: int = 1, dtype: str = "float32",
                  device=DEFAULT_DEVICE) -> MarigoldPipeline:
    unet_state, unet_cfg_d = _load_component(checkpoint_dir, "unet")
    vae_state, vae_cfg_d = _load_component(checkpoint_dir, "vae")
    unet_cfg, vae_cfg = _config(unet_cfg_d, UNet2DConfig), _config(vae_cfg_d, VAEConfig)
    embed_path = os.path.join(checkpoint_dir, "empty_text_embed.npy")
    if os.path.exists(embed_path):
        embed = np.load(embed_path).astype(np.float32)
    else:
        warnings.warn("empty_text_embed.npy missing: conditioning on a zero text context "
                      "(precompute it with CLIPTextModel for full parity)")
        embed = np.zeros((1, 77, unet_cfg.cross_attention_dim), np.float32)
    unet = load_diffusers_state(UNet2DCondition(unet_cfg), unet_state)
    vae = load_diffusers_state(AutoencoderKL(vae_cfg),
                               identity_quant_convs(vae_state, vae_cfg.latent_channels))
    return MarigoldPipeline(unet, vae, embed, num_steps=steps, ensemble_size=ensemble,
                            dtype=dtype, device=device)


def load_diffusion_pipeline(name: str, checkpoint=None, steps: int | None = None,
                            window: int = 24, overlap: int = 6, ensemble: int = 1,
                            allow_random: bool = False, dtype: str = "float32",
                            device=DEFAULT_DEVICE):
    """The diffusion catalog entries: ``checkpoint`` is a Marigold or a
    DepthCrafter directory (by ``name``); without one, ``allow_random=True``
    gives the family's tiny random-weight pipeline (noise, for shape testing
    only). ``window`` and ``overlap`` are DepthCrafter's, ``ensemble``
    Marigold's."""
    is_dc = "depthcrafter" in name
    if checkpoint is None:
        if not allow_random:
            raise ValueError(f"{name}: diffusion depth needs a checkpoint directory (random "
                             f"weights produce noise, not depth). Pass allow_random=True for "
                             f"shape testing only.")
        if is_dc:
            return tiny_depthcrafter(steps=steps or 2, window=window, overlap=overlap,
                                     dtype=dtype, device=device)
        return tiny_marigold(steps=steps or 2, dtype=dtype, device=device)
    if is_dc:
        return load_depthcrafter(checkpoint, steps=steps or 2, window=window, overlap=overlap,
                                 dtype=dtype, device=device)
    return load_marigold(checkpoint, steps=steps or 4, ensemble=ensemble, dtype=dtype,
                         device=device)
