"""ZoeDepth: metric depth from adaptive bins on a BEiT + DPT trunk.

Counterpart of ``visiondepth3d_tpu/depth/zoedepth.py``, the reference
catalog's "ZoeDepth" entry (Intel/zoedepth-nyu and -nyu-kitti). Per HF
``modeling_zoedepth.py``: the BEiT backbone (``depth/beit.py``) -> the DPT
neck with the project readout (``depth/dpt_classic.py``) -> the relative
depth head, whose features condition the metric head: a seed bin
regressor, four rounds of unnormed attractors over the fusion outputs, a
conditional log-binomial over the bins, and depth = sum(p_i * center_i).

- ``ZoeDepth``: the single-domain head (NYU; softplus bin centers).
- ``ZoeDepthNK``: the two-domain router. A patch transformer over the
  bottleneck (sinusoidal positions, a zero class token, four post-norm
  layers) votes NYU or KITTI for the batch; both domains' bin heads run and
  the vote selects one. Every attractor has 16 points
  (``router_attractors``), as HF's two-head constructor leaves them.
  Returns (depth, domain_logits).

Parameter names follow HF ``ZoeDepthForDepthEstimation`` (``backbone.*``,
``neck.*``, ``relative_head.*``, ``metric_head.*``). The patch
transformer's LayerNorms take the JAX package's epsilon (1e-6).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.resize import resize_bilinear
from .beit import BEIT_TINY, BEiTBackbone, BEiTConfig
from .dpt import _conv3
from .dpt_classic import DPTNeck


@dataclasses.dataclass(frozen=True)
class ZoeDepthConfig:
    backbone: BEiTConfig = BEiTConfig()
    out_indices: tuple = (6, 12, 18, 24)
    reassemble_factors: tuple = (4, 2, 1, 0.5)
    neck_hidden_sizes: tuple = (256, 512, 1024, 1024)
    fusion_hidden_size: int = 256
    bottleneck_features: int = 256
    num_relative_features: int = 32
    bin_embedding_dim: int = 128
    n_bins: int = 64
    num_attractors: tuple = (16, 8, 4, 1)
    min_depth: float = 1e-3
    max_depth: float = 10.0
    attractor_alpha: float = 1000.0
    attractor_kind: str = "mean"
    min_temp: float = 0.0212
    max_temp: float = 50.0


ZOE_TINY = ZoeDepthConfig(
    backbone=BEIT_TINY,
    out_indices=(1, 2, 3, 4),
    neck_hidden_sizes=(16, 24, 32, 40),
    fusion_hidden_size=16,
    bottleneck_features=16,
    num_relative_features=8,
    bin_embedding_dim=8,
    n_bins=8,
    num_attractors=(4, 2, 2, 1),
)


@dataclasses.dataclass(frozen=True)
class ZoeDomain:
    name: str = "nyu"
    n_bins: int = 64
    min_depth: float = 1e-3
    max_depth: float = 10.0


@dataclasses.dataclass(frozen=True)
class ZoeDepthNKConfig:
    base: ZoeDepthConfig = ZoeDepthConfig()
    domains: tuple = (ZoeDomain("nyu", 64, 1e-3, 10.0),
                      ZoeDomain("kitti", 64, 1e-3, 80.0))
    patch_transformer_hidden_size: int = 128
    patch_transformer_intermediate_size: int = 1024
    patch_transformer_heads: int = 4
    num_patch_transformer_layers: int = 4
    # HF's two-head constructor passes num_attractors[i] as n_bins, leaving
    # every attractor at its default of 16 points: kept for its checkpoints
    router_attractors: int = 16


ZOE_NK_TINY = ZoeDepthNKConfig(
    base=ZOE_TINY,
    domains=(ZoeDomain("nyu", 8, 1e-3, 10.0), ZoeDomain("kitti", 8, 1e-3, 80.0)),
    # HF hard-codes the classifier input at 128 and four layers
    patch_transformer_hidden_size=128,
    patch_transformer_intermediate_size=32,
    patch_transformer_heads=2,
    num_patch_transformer_layers=4,
)

# HF keys the port's models do not hold: the first fusion layer's residual
# unit, which has no residual input to act on.
UNUSED_HF_KEYS = ("neck.fusion_stage.layers.0.residual_layer1.",)


def _up(x: torch.Tensor, hw) -> torch.Tensor:
    return resize_bilinear(x, tuple(hw), align_corners=True, channel_last=False)


def log_binom(n, k, eps: float = 1e-7):
    n = n + eps
    k = k + eps
    return n * torch.log(n) - k * torch.log(k) - (n - k) * torch.log(n - k + eps)


def inv_attractor(dx, alpha: float = 1000.0, gamma: int = 2):
    """The inverse attractor's pull dx / (1 + alpha dx^gamma)."""
    return dx / (1.0 + alpha * dx ** gamma)


class _TwoConv(nn.Module):
    """conv1 (1x1) -> ReLU -> conv2 (1x1): HF's seed regressors, projectors
    and attractors share these names."""

    def __init__(self, cin: int, mid: int, cout: int):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, mid, 1)
        self.conv2 = nn.Conv2d(mid, cout, 1)

    def forward(self, x):
        return self.conv2(F.relu(self.conv1(x)))


class SeedBinRegressor(_TwoConv):
    """Softplus ("unnormed") bin centers."""

    def forward(self, x):
        return F.softplus(super().forward(x))


class AttractorLayerUnnormed(_TwoConv):
    def __init__(self, cfg: ZoeDepthConfig, n_attractors: int):
        super().__init__(cfg.bin_embedding_dim, cfg.bin_embedding_dim, n_attractors)
        self.alpha = cfg.attractor_alpha
        self.kind = cfg.attractor_kind

    def forward(self, x, prev_bin, prev_emb):
        """New bin centers [B, n_bins, h, w] at x's resolution."""
        if prev_emb.shape[2:] != x.shape[2:]:
            prev_emb = _up(prev_emb, x.shape[2:])
        x = x + prev_emb
        attractors = F.softplus(super().forward(x))  # [B, A, h, w]
        centers = _up(prev_bin, x.shape[2:])  # [B, n_bins, h, w]
        dx = attractors[:, :, None] - centers[:, None]  # [B, A, n_bins, h, w]
        delta = inv_attractor(dx, self.alpha)
        delta = delta.mean(1) if self.kind == "mean" else delta.sum(1)
        return centers + delta


class ConditionalLogBinomial(nn.Module):
    """Per pixel: a binomial's log-probabilities over the bins, from a
    predicted p and temperature, softmaxed (float32 from the log terms on,
    as the JAX package's type promotion gives)."""

    def __init__(self, cfg: ZoeDepthConfig, in_features: int, n_bins: int,
                 bottleneck_factor: int = 2):
        super().__init__()
        bottleneck = (in_features + cfg.bin_embedding_dim) // bottleneck_factor
        self.mlp = nn.Sequential(nn.Conv2d(in_features + cfg.bin_embedding_dim, bottleneck, 1),
                                 nn.GELU(), nn.Conv2d(bottleneck, 4, 1), nn.Softplus())
        self.n_bins = n_bins
        self.min_temp, self.max_temp = cfg.min_temp, cfg.max_temp

    def forward(self, main, condition):
        h = self.mlp(torch.cat([main, condition], dim=1))
        prob = h[:, 0:2] + 1e-4
        p = prob[:, 0] / (prob[:, 0] + prob[:, 1])
        temp = h[:, 2:4] + 1e-4
        t = temp[:, 0] / (temp[:, 0] + temp[:, 1])
        t = (self.max_temp - self.min_temp) * t + self.min_temp
        k_idx = torch.arange(self.n_bins, dtype=torch.float32, device=h.device)[:, None, None]
        k_m1 = torch.full((), float(self.n_bins - 1), device=h.device)
        p = torch.clamp(p, 1e-4, 1.0)[:, None]
        omp = torch.clamp(1.0 - p, 1e-4, 1.0)
        y = log_binom(k_m1, k_idx) + k_idx * torch.log(p) + (k_m1 - k_idx) * torch.log(omp)
        return torch.softmax(y / t[:, None], dim=1)


class RelativeHead(nn.Module):
    def __init__(self, cfg: ZoeDepthConfig):
        super().__init__()
        f = cfg.fusion_hidden_size
        self.conv1 = _conv3(f, f // 2)
        self.conv2 = _conv3(f // 2, cfg.num_relative_features)
        self.conv3 = nn.Conv2d(cfg.num_relative_features, 1, 1)

    def forward(self, x):
        """(features [B, num_relative_features, H, W], relative depth [B, 1, H, W])."""
        x = self.conv1(x)
        x = F.relu(self.conv2(_up(x, (x.shape[2] * 2, x.shape[3] * 2))))
        return x, F.relu(self.conv3(x))


class _ZoeTrunk(nn.Module):
    """Backbone + neck + relative head, shared by both variants."""

    def __init__(self, cfg: ZoeDepthConfig):
        super().__init__()
        self.backbone = BEiTBackbone(cfg.backbone, cfg.out_indices)
        self.neck = DPTNeck(cfg, cfg.backbone.hidden_size)
        self.relative_head = RelativeHead(cfg)

    def trunk(self, pixels):
        feats, grid = self.backbone(pixels)
        fused_all, bottleneck = self.neck(feats, grid)
        rel_features, relative_depth = self.relative_head(fused_all[-1])
        return bottleneck, fused_all, rel_features, relative_depth


class MetricHead(nn.Module):
    def __init__(self, cfg: ZoeDepthConfig):
        super().__init__()
        e = cfg.bin_embedding_dim
        self.conv2 = nn.Conv2d(cfg.fusion_hidden_size, cfg.bottleneck_features, 1)
        self.seed_bin_regressor = SeedBinRegressor(cfg.bottleneck_features, 256, cfg.n_bins)
        self.seed_projector = _TwoConv(cfg.bottleneck_features, 128, e)
        self.projectors = nn.ModuleList(_TwoConv(cfg.fusion_hidden_size, 128, e)
                                        for _ in range(4))
        self.attractors = nn.ModuleList(AttractorLayerUnnormed(cfg, cfg.num_attractors[i])
                                        for i in range(4))
        self.conditional_log_binomial = ConditionalLogBinomial(
            cfg, cfg.num_relative_features + 1, cfg.n_bins)

    def forward(self, bottleneck, fused_all, rel_features, relative_depth):
        b = self.conv2(bottleneck)
        prev_bin = self.seed_bin_regressor(b)
        prev_emb = self.seed_projector(b)
        for proj, attractor, feature in zip(self.projectors, self.attractors, fused_all):
            emb = proj(feature)
            prev_bin = attractor(emb, prev_bin, prev_emb)
            prev_emb = emb
        last = torch.cat([rel_features, _up(relative_depth, rel_features.shape[2:])], dim=1)
        probs = self.conditional_log_binomial(last, _up(prev_emb, last.shape[2:]))
        return torch.sum(probs * _up(prev_bin, probs.shape[2:]), dim=1)


class ZoeDepth(_ZoeTrunk):
    """[B, 3, H, W] pixels (mean/std 0.5) -> [B, H, W] metric depth."""

    def __init__(self, cfg: ZoeDepthConfig = ZoeDepthConfig()):
        super().__init__(cfg)
        self.cfg = cfg
        self.metric_head = MetricHead(cfg)

    def forward(self, pixels):
        return self.metric_head(*self.trunk(pixels))


def sinusoid_1d(seq: int, dim: int, device=None) -> torch.Tensor:
    """[seq, dim] positions: sin on the first half of the channels, cos on
    the second."""
    pos = torch.arange(seq, dtype=torch.float32, device=device)[:, None]
    idx = torch.arange(0, dim, 2, dtype=torch.float32, device=device)[None, :]
    pe = pos * torch.exp(idx * (-torch.log(torch.tensor(10000.0)) / dim))
    return torch.cat([torch.sin(pe), torch.cos(pe)], dim=1)


class _PatchAttention(nn.Module):
    def __init__(self, c: int, heads: int):
        super().__init__()
        self.heads = heads
        self.query = nn.Linear(c, c)
        self.key = nn.Linear(c, c)
        self.value = nn.Linear(c, c)
        self.out_proj = nn.Linear(c, c)

    def forward(self, x):
        b, n, c = x.shape

        def heads(t):
            return t.reshape(b, n, self.heads, c // self.heads).transpose(1, 2)

        att = F.scaled_dot_product_attention(heads(self.query(x)), heads(self.key(x)),
                                             heads(self.value(x)))
        return self.out_proj(att.transpose(1, 2).reshape(b, n, c))


class PatchTransformerLayer(nn.Module):
    """Post-norm encoder layer (torch ``TransformerEncoderLayer`` order)."""

    def __init__(self, cfg: ZoeDepthNKConfig):
        super().__init__()
        c = cfg.patch_transformer_hidden_size
        self.self_attn = _PatchAttention(c, cfg.patch_transformer_heads)
        self.linear1 = nn.Linear(c, cfg.patch_transformer_intermediate_size)
        self.linear2 = nn.Linear(cfg.patch_transformer_intermediate_size, c)
        self.norm1 = nn.LayerNorm(c, eps=1e-6)
        self.norm2 = nn.LayerNorm(c, eps=1e-6)

    def forward(self, x):
        x = self.norm1(x + self.self_attn(x))
        return self.norm2(x + self.linear2(F.relu(self.linear1(x))))


class PatchTransformer(nn.Module):
    def __init__(self, cfg: ZoeDepthNKConfig):
        super().__init__()
        self.embedding_convPxP = nn.Conv2d(cfg.base.bottleneck_features,
                                           cfg.patch_transformer_hidden_size, 1)
        self.transformer_encoder = nn.ModuleList(
            PatchTransformerLayer(cfg) for _ in range(cfg.num_patch_transformer_layers))

    def forward(self, x):
        """The class token's features [B, hidden]."""
        tokens = self.embedding_convPxP(x).flatten(2).transpose(1, 2)
        tokens = F.pad(tokens, (0, 0, 1, 0))
        tokens = tokens + sinusoid_1d(tokens.shape[1], tokens.shape[2],
                                      tokens.device).to(tokens.dtype)
        for layer in self.transformer_encoder:
            tokens = layer(tokens)
        return tokens[:, 0]


class _Classifier(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.linear1 = nn.Linear(c, c)
        self.linear2 = nn.Linear(c, 2)

    def forward(self, x):
        return self.linear2(F.relu(self.linear1(x)))


class MultiMetricHead(nn.Module):
    def __init__(self, cfg: ZoeDepthNKConfig):
        super().__init__()
        base, e = cfg.base, cfg.base.bin_embedding_dim
        self.domains = cfg.domains
        self.conv2 = nn.Conv2d(base.fusion_hidden_size, base.bottleneck_features, 1)
        self.patch_transformer = PatchTransformer(cfg)
        self.mlp_classifier = _Classifier(cfg.patch_transformer_hidden_size)
        self.seed_projector = _TwoConv(base.bottleneck_features, e // 2, e)
        self.projectors = nn.ModuleList(_TwoConv(base.fusion_hidden_size, e // 2, e)
                                        for _ in range(4))
        self.seed_bin_regressors = nn.ModuleDict(
            {d.name: SeedBinRegressor(base.bottleneck_features, e // 2, d.n_bins)
             for d in cfg.domains})
        self.attractors = nn.ModuleDict(
            {d.name: nn.ModuleList(AttractorLayerUnnormed(base, cfg.router_attractors)
                                   for _ in range(4)) for d in cfg.domains})
        self.conditional_log_binomial = nn.ModuleDict(
            {d.name: ConditionalLogBinomial(base, base.num_relative_features, d.n_bins,
                                            bottleneck_factor=4) for d in cfg.domains})

    def forward(self, bottleneck, fused_all, rel_features):
        x = self.conv2(bottleneck)
        domain_logits = self.mlp_classifier(self.patch_transformer(x))
        domain_idx = torch.argmax(torch.softmax(domain_logits.sum(0), dim=0))
        seed_emb = self.seed_projector(x)
        embs = [proj(f) for proj, f in zip(self.projectors, fused_all)]
        hw = rel_features.shape[2:]
        depths = []
        for d in self.domains:  # both run; the vote selects one on the device
            prev_bin, prev_emb = self.seed_bin_regressors[d.name](x), seed_emb
            for attractor, emb in zip(self.attractors[d.name], embs):
                prev_bin = attractor(emb, prev_bin, prev_emb)
                prev_emb = emb
            probs = self.conditional_log_binomial[d.name](rel_features, _up(prev_emb, hw))
            depths.append(torch.sum(probs * _up(prev_bin, hw), dim=1))
        return torch.where(domain_idx == 0, depths[0], depths[1]), domain_logits


class ZoeDepthNK(_ZoeTrunk):
    """The NYU + KITTI router: [B, 3, H, W] pixels (mean/std 0.5) ->
    ([B, H, W] metric depth, [B, 2] domain logits)."""

    def __init__(self, cfg: ZoeDepthNKConfig = ZoeDepthNKConfig()):
        super().__init__(cfg.base)
        self.cfg = cfg
        self.metric_head = MultiMetricHead(cfg)

    def forward(self, pixels):
        bottleneck, fused_all, rel_features, _ = self.trunk(pixels)
        return self.metric_head(bottleneck, fused_all, rel_features)
