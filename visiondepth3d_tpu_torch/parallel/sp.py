"""Row sharding of the depth model (``depth --mesh sp=M``): a token-parallel
DINOv2 and a row-banded DPT neck and head, for the Depth Anything family
(``dpt_dinov2``: ``depth/dinov2.py``, ``depth/dpt.py``).

Counterpart of the JAX package's sp depth route, where ``P("dp", "sp")``
on the frames lets GSPMD partition the resize, the ViT, the neck and the
percentiles over rows and insert the all-gathers global attention needs
(``visiondepth3d_tpu/pipeline/depth_pipeline.py:_resolve_mesh``,
``make_depth_batch_fn``). The result is the one-device depth, so that is
what this module computes, band by band, with the collectives written out.
One controller holds every band (a ``halo.RowSharded``: a tensor per
device plus the global row bounds); a device may repeat.

- Token ownership: band b owns patch rows [r0, r1) of the (gh, gw) grid
  (``split_rows(gh, M)``); the cls token lives on band 0. The band's
  pixels are the 14-row-aligned rows of those patches, resized from the
  source rows that they read (``ops/resize.source_rows``), so each band's
  device receives only its share of the frame.
- Embedding: the band's patches plus its rows of the regridded position
  table (``dinov2.interpolate_pos_embed``; band 0 adds the cls row).
- Each block: LayerNorm, q, k and v run on the band; K and V are gathered
  in band order onto every band's device (cls first: one device's token
  order); the band's queries attend to the whole sequence through
  ``ops/attention.band_attention`` (routed by the global token count: K7's
  query-band form under its opt-in, else SDPA); the output projection,
  LayerScale and MLP run on the band. The ``out_indices`` features stay
  on their bands.
- The neck and head (the cls token dropped, as one device drops it): each
  level's rows split by ``split_rows`` over that level's height. The 1x1
  projections and the transposed convolution (kernel = stride) run on the
  band; every 3x3 convolution (the level-4 stride-2 one too) fetches the
  source rows its output band reads (``RowSharded.rows``: a one-row halo,
  zeros outside the frame) and runs with no row padding and its column
  padding kept; every resize computes its output band from the source rows
  it reads (``ops/resize.resize_bilinear_rows``).

The weights are the model's own ``nn.Module`` parameters, replicated once
per distinct device (``parallel/mesh.replicas``). A band's row sums and
products have the same terms as one device's; the library convolutions
and GEMMs may order them otherwise at another shape, so float32 depth is
within 1e-5 of its range of one device, not bit-identical.

``split_rows`` cuts bands of any start (``halo.band_bounds``' even starts
serve the render's 4:2:0 chroma); at 518^2 the 37 patch rows split as
``band_bounds(37, 2)`` does, [(0, 18), (18, 37)]. A level with fewer rows
than bands (the stride-2 level of a small frame) leaves a band empty.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..depth.dinov2 import interpolate_pos_embed
from ..depth.dpt import DepthAnything
from ..depth.model import DepthPredictor
from ..device import host_to_device
from ..ops.attention import band_attention
from ..ops.resize import resize_bilinear_rows, source_rows
from .halo import RowSharded, lead_cat
from .mesh import replicas


def split_rows(height: int, n: int) -> list[tuple[int, int]]:
    """``n`` bands [r0, r1) of ``height`` rows, as even as possible (an
    empty band where height < n)."""
    cuts = [round(i * height / n) for i in range(n + 1)]
    return list(zip(cuts[:-1], cuts[1:]))


def _each(x: RowSharded, fns, scale: int = 1) -> RowSharded:
    """fns[b] (or one fn for every band) applied to band b on its device: a
    row-local op whose output rows are the band's times ``scale``."""
    fns = fns if isinstance(fns, (list, tuple)) else [fns] * len(x.bands)
    return RowSharded([f(t) for f, t in zip(fns, x.bands)],
                      [(scale * a, scale * b) for a, b in x.bounds], x.h_axis)


def _add(x: RowSharded, y: RowSharded) -> RowSharded:
    """x + y, band by band (both split at the same bounds)."""
    if list(x.bounds) != list(y.bounds):
        raise ValueError(f"bands {x.bounds} and {y.bounds} differ")
    return RowSharded([a + b for a, b in zip(x.bands, y.bands)], x.bounds, x.h_axis)


def _empty_rows(like: torch.Tensor, h_axis: int, width: int | None = None,
                channels: int | None = None) -> torch.Tensor:
    """A band of no rows shaped like ``like`` with ``width`` columns (last
    axis) and ``channels`` channels (axis 1) where given."""
    shape = list(like.shape)
    shape[h_axis] = 0
    if width is not None:
        shape[-1] = width
    if channels is not None:
        shape[1] = channels
    return like.new_zeros(shape)


def conv_rows(x: RowSharded, convs: list, bounds=None, pre=None) -> RowSharded:
    """``nn.Conv2d`` (kernel k, stride s, padding p; one replica per band)
    over an NCHW RowSharded map: output band [y0, y1) from input rows
    [s y0 - p, s (y1 - 1) - p + k) (zeros outside the frame), ``pre``
    (an elementwise op that keeps zero at zero, relu) applied to them, and
    the convolution run with no row padding and its column padding kept.
    Output bounds: ``bounds``, else x's for a stride-1 conv and
    ``split_rows`` of the output height for a strided one."""
    c = convs[0]
    (k, kw), (s, sw), (p, pw) = c.kernel_size, c.stride, c.padding
    h_out = (x.height + 2 * p - k) // s + 1
    if bounds is None:
        same = s == 1 and k == 2 * p + 1
        bounds = x.bounds if same else split_rows(h_out, len(x.bands))
    out = []
    for (y0, y1), conv, band, dev in zip(bounds, convs, x.bands, x.devices):
        if y1 == y0:
            out.append(_empty_rows(band, 2, (band.shape[-1] + 2 * pw - kw) // sw + 1,
                                   conv.out_channels))
            continue
        src = x.rows(s * y0 - p, s * (y1 - 1) - p + k, dev)
        if pre is not None:
            src = pre(src)
        out.append(F.conv2d(src, conv.weight, conv.bias, stride=c.stride, padding=(0, pw)))
    return RowSharded(out, list(bounds), 2)


def resize_rows(x: RowSharded, out_hw, align_corners: bool, bounds) -> RowSharded:
    """``resize_bilinear(x, out_hw, align_corners)`` of a RowSharded map
    whose last two axes are (rows, columns), its output split at
    ``bounds``: each output band from the source rows it reads."""
    out = []
    for (r0, r1), band, dev in zip(bounds, x.bands, x.devices):
        if r1 == r0:
            out.append(_empty_rows(band, x.h_axis, out_hw[1]))
            continue
        a, b = source_rows(x.height, out_hw[0], (r0, r1), align_corners)
        out.append(resize_bilinear_rows(x.rows(a, b, dev), x.height, out_hw, (r0, r1), a,
                                        align_corners, channel_last=False))
    return RowSharded(out, [tuple(r) for r in bounds], x.h_axis)


class SPDepthAnything:
    """A ``DepthAnything`` row-sharded over ``devices`` (band b on
    devices[b]; a device may repeat): the model's own parameters, one
    replica per distinct device."""

    def __init__(self, model: DepthAnything, devices):
        if type(model) is not DepthAnything:
            raise TypeError(f"row sharding takes a DepthAnything, got {type(model).__name__}")
        self.devices = [torch.device(d) for d in devices]
        reps = replicas(model, self.devices)
        self.models = [reps[d] for d in self.devices]
        self.cfg = model.cfg

    @property
    def n(self) -> int:
        return len(self.devices)

    def token_bounds(self, gh: int) -> list[tuple[int, int]]:
        """Each band's patch rows; raises ValueError where a band would own
        none."""
        if gh < self.n:
            p = self.cfg.backbone.patch_size
            raise ValueError(f"sp={self.n} needs at least {self.n} patch rows (an inference "
                             f"height of {self.n * p}); got {gh}")
        return split_rows(gh, self.n)

    # ------------------------------------------------------------ backbone

    def _embed(self, pixels: list, tokens, grid) -> list:
        gh, gw = grid
        pos_on = {}
        out = []
        for b, (m, px, (r0, r1)) in enumerate(zip(self.models, pixels, tokens)):
            emb = m.backbone.embeddings
            if px.device not in pos_on:
                pos_on[px.device] = interpolate_pos_embed(emb.position_embeddings, grid,
                                                          emb.pos_resize)
            pos = pos_on[px.device]
            x = emb.patch_embeddings(px) + pos[:, 1 + r0 * gw: 1 + r1 * gw]
            if b == 0:
                x = torch.cat([emb.cls_token.expand(x.shape[0], -1, -1) + pos[:, :1], x], dim=1)
            out.append(x)
        return out

    def _block(self, i: int, xs: list) -> list:
        blocks = [m.backbone.encoder.layer[i] for m in self.models]
        qkv = []
        for blk, x in zip(blocks, xs):
            a, h = blk.attention.attention, blk.norm1(x)
            qkv.append((a.query(h), a.key(h), a.value(h)))
        # K and V of every band, in band order, on each distinct device
        kv = {d: (lead_cat([t[1] for t in qkv], d, 1), lead_cat([t[2] for t in qkv], d, 1))
              for d in dict.fromkeys(self.devices)}
        out = []
        for blk, x, (q, _, _), d in zip(blocks, xs, qkv, self.devices):
            attn = blk.attention
            b, n, c = q.shape
            heads, hd = attn.num_heads, c // attn.num_heads
            k, v = kv[d]
            o = band_attention(q.reshape(b, n, heads, hd), k.reshape(b, -1, heads, hd),
                               v.reshape(b, -1, heads, hd))
            x = x + blk.layer_scale1(attn.output(o.reshape(b, n, c)))
            out.append(x + blk.layer_scale2(blk.mlp(blk.norm2(x))))
        return out

    def backbone(self, pixels: list, tokens, grid) -> list:
        """The final-LayerNorm hidden states after the ``out_indices``
        blocks, each a list of bands (band 0 with the cls token first)."""
        out_indices = self.models[0].backbone.out_indices

        def norm(xs):
            return [m.backbone.layernorm(x) for m, x in zip(self.models, xs)]

        xs = self._embed(pixels, tokens, grid)
        feats = [norm(xs)] if 0 in out_indices else []
        for i in range(len(self.models[0].backbone.encoder.layer)):
            xs = self._block(i, xs)
            if i + 1 in out_indices:
                feats.append(norm(xs))
        return feats

    # ---------------------------------------------------------- neck, head

    def _preact(self, mods: list, x: RowSharded) -> RowSharded:
        h = conv_rows(x, [m.convolution1 for m in mods], pre=F.relu)
        return _add(x, conv_rows(h, [m.convolution2 for m in mods], pre=F.relu))

    def _fusion(self, idx: int, x: RowSharded, residual: RowSharded | None,
                nxt: RowSharded | None) -> RowSharded:
        layers = [m.neck.fusion_stage.layers[idx] for m in self.models]
        if residual is not None:
            # x was resized to this level's size and bands (``nxt`` below),
            # so the residual's resize in FeatureFusionLayer never applies
            x = _add(x, self._preact([l.residual_layer1 for l in layers], residual))
        x = self._preact([l.residual_layer2 for l in layers], x)
        if nxt is not None:
            target, bounds = (nxt.height, nxt.bands[0].shape[-1]), nxt.bounds
        else:
            target = (2 * x.height, 2 * x.bands[0].shape[-1])
            bounds = split_rows(target[0], self.n)
        x = resize_rows(x, target, True, bounds)
        return _each(x, [l.projection for l in layers])

    def neck(self, feats: list, tokens, grid) -> RowSharded:
        gw = grid[1]
        maps = []
        for lvl, feat in enumerate(feats):
            bands = []
            for b, (t, (r0, r1)) in enumerate(zip(feat, tokens)):
                t = t[:, 1:] if b == 0 else t  # drop cls
                bands.append(t.transpose(1, 2).reshape(t.shape[0], -1, r1 - r0, gw))
            layers = [m.neck.reassemble_stage.layers[lvl] for m in self.models]
            x = _each(RowSharded(bands, list(tokens), 2), [l.projection for l in layers])
            resize = layers[0].resize
            if isinstance(resize, nn.ConvTranspose2d):  # kernel = stride: row-local
                x = _each(x, [l.resize for l in layers], scale=resize.stride[0])
            elif isinstance(resize, nn.Conv2d):
                x = conv_rows(x, [l.resize for l in layers])
            maps.append(conv_rows(x, [m.neck.convs[lvl] for m in self.models]))
        rev = maps[::-1]
        fused = None
        for idx, hs in enumerate(rev):
            nxt = rev[idx + 1] if idx != len(rev) - 1 else None
            fused = (self._fusion(idx, hs, None, nxt) if fused is None
                     else self._fusion(idx, fused, hs, nxt))
        return fused

    def head(self, x: RowSharded, grid) -> RowSharded:
        """[B, rows, w] depth bands (h_axis 1)."""
        heads = [m.head for m in self.models]
        cfg, fast = self.cfg, heads[0].fast_head
        p = cfg.backbone.patch_size
        out_hw = (grid[0] * p, grid[1] * p)
        bounds = split_rows(out_hw[0], self.n)
        x = conv_rows(x, [h.conv1 for h in heads])
        if not fast:
            x = resize_rows(x, out_hw, True, bounds)
        x = conv_rows(x, [h.conv2 for h in heads])
        act = F.relu if cfg.depth_estimation_type == "relative" else torch.sigmoid
        x = _each(x, [lambda t, h=h: act(h.conv3(F.relu(t)))[:, 0] * cfg.max_depth
                      for h in heads])
        x = RowSharded(x.bands, x.bounds, 1)
        if fast:
            x = resize_rows(x, out_hw, True, bounds)
        return x

    def __call__(self, pixels: list, grid) -> RowSharded:
        """Normalized pixel bands [B, 3, p (r1 - r0), W] (band b's patch rows
        of the ``grid``) -> [B, rows, w] depth bands."""
        tokens = self.token_bounds(grid[0])
        feats = self.backbone(pixels, tokens, grid)
        return self.head(self.neck(feats, tokens, grid), grid)


class SPPredictor:
    """A ``DepthPredictor`` of the Depth Anything family with its model
    row-sharded over ``devices`` (``SPDepthAnything``): the same inference
    size, type and input statistics. Band b's frames live on devices[b];
    the lead, devices[0], gathers."""

    def __init__(self, predictor, devices):
        self.devices = [torch.device(d) for d in devices]
        self.model = SPDepthAnything(predictor.model, self.devices)
        self.cfg = predictor.cfg
        self._size = predictor._size
        self._dtype = predictor._mean.dtype
        stats = {d: (predictor._mean.to(d), predictor._std.to(d))
                 for d in dict.fromkeys(self.devices)}
        self._stats = [stats[d] for d in self.devices]

    @property
    def lead(self) -> torch.device:
        return self.devices[0]

    @property
    def grid(self) -> tuple[int, int]:
        p = self.cfg.backbone.patch_size
        return self._size[0] // p, self._size[1] // p

    def source_bounds(self, height: int) -> list[tuple[int, int]]:
        """The rows of a ``height``-row frame that each band's input resize
        reads."""
        p = self.cfg.backbone.patch_size
        return [source_rows(height, self._size[0], (p * r0, p * r1))
                for r0, r1 in self.model.token_bounds(self.grid[0])]

    def scatter(self, frames_u8: np.ndarray) -> list:
        """The u8 source rows each band's input resize reads, of a host batch
        [B, H, W, 3], copied to the band's device (float in [0, 1] there)."""
        return [host_to_device(np.ascontiguousarray(frames_u8[:, a:b]), d).to(torch.float32)
                / 255.0 for (a, b), d in zip(self.source_bounds(frames_u8.shape[1]),
                                            self.devices)]

    @torch.no_grad()
    def forward_rows(self, frames: list, height: int) -> RowSharded:
        """Band b's source rows (``source_bounds(height)[b]``) of [B, H, W, 3]
        float RGB frames in [0, 1], on devices[b] -> the raw depth [B, h, w]
        float32 as row bands: the rows of ``DepthPredictor.__call__``."""
        p = self.cfg.backbone.patch_size
        pixels = []
        for x, (a, _), (r0, r1), (mean, std) in zip(
                frames, self.source_bounds(height), self.model.token_bounds(self.grid[0]),
                self._stats):
            x = resize_bilinear_rows(x.to(self._dtype), height, self._size,
                                     (p * r0, p * r1), a, channel_last=True)
            pixels.append(((x - mean) / std).permute(0, 3, 1, 2))
        depth = self.model(pixels, self.grid)
        return RowSharded([d.float() for d in depth.bands], depth.bounds, depth.h_axis)

    def __call__(self, frames01: torch.Tensor) -> torch.Tensor:
        """[B, H, W, 3] float RGB in [0, 1] -> [B, h, w] float32 raw depth on
        the lead, as ``DepthPredictor.__call__`` gives it."""
        h = frames01.shape[1]
        bands = [frames01[:, a:b].to(d) for (a, b), d in zip(self.source_bounds(h),
                                                             self.devices)]
        return self.forward_rows(bands, h).gather(self.lead)


def is_row_shardable(predictor) -> bool:
    """Whether ``predictor`` runs under sp: a ``DepthPredictor`` whose model
    is a ``DepthAnything`` (the ten ``dpt_dinov2`` catalog entries, or a
    ``local:`` folder of one)."""
    return (isinstance(predictor, DepthPredictor) and type(predictor.model) is DepthAnything
            and predictor.select is None)
