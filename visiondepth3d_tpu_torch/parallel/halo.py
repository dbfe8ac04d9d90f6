"""Row bands of a frame over devices: the split, the halo exchange, the
gather, and sums on a lead device in a fixed order.

Counterpart of ``visiondepth3d_tpu/parallel/halo.py``. There,
``halo_exchange_rows`` runs inside ``shard_map`` and ships each shard's
boundary rows to its neighbours with ``ppermute``. Here one controller
holds every band (a list of tensors, band ``b`` on its device) and the
exchange is a ``.to(device)`` copy of the neighbours' rows, enqueued
asynchronously; on a repeated device (``[cuda:0, cuda:0]``) it is a copy on
that device.

The public ``halo_exchange_rows`` keeps the JAX function's contract: every
band gets ``halo`` rows on both sides, zeros on the outer side of the edge
bands. The renders use ``outer="none"``: the edge bands get no outer halo,
so every stencil meets the image's true border (zero padding, reflection,
the row-0 gradient rule) exactly as on one device, and a padded band's
stencil results are exact on the band's own rows as long as the chain's
total reach is at most ``halo``.
"""

from __future__ import annotations

import dataclasses

import torch


def band_bounds(height: int, n: int, halo: int = 0) -> list[tuple[int, int]]:
    """``n`` row bands [r0, r1) of a frame ``height`` rows high: as even as
    possible, each starting on an even row, each at least ``halo`` rows (and
    one) high. Raises ValueError, naming the least height that splits,
    where the frame is too short."""
    if n < 1:
        raise ValueError(f"{n} bands")
    need = max(halo, 1)

    def cuts(h):
        return [2 * round(i * h / (2 * n)) for i in range(n)] + [h]

    def fits(h):
        c = cuts(h)
        return all(b - a >= need for a, b in zip(c[:-1], c[1:]))

    if not fits(height):
        least = next(h for h in range(n * need, n * (need + 4)) if fits(h))
        raise ValueError(f"sp={n} needs frames of at least {least} rows (bands of {need} rows "
                         f"for a halo of {halo}); got {height}")
    c = cuts(height)
    return list(zip(c[:-1], c[1:]))


def halo_exchange_rows(bands: list[torch.Tensor], halo: int, outer: str = "zeros",
                       h_axis: int = 0) -> list[torch.Tensor]:
    """Each band padded with ``halo`` rows of its neighbours along
    ``h_axis``, on the band's device. ``outer``: "zeros" pads the outer side
    of the edge bands with zeros (the JAX function's contract); "none"
    leaves it unpadded. Every band must hold at least ``halo`` rows."""
    if outer not in ("zeros", "none"):
        raise ValueError(f"outer={outer!r}")
    n = len(bands)
    if halo == 0:
        return list(bands)
    for x in bands:
        if x.shape[h_axis] < halo:
            raise ValueError(f"a band of {x.shape[h_axis]} rows cannot lend a halo of {halo}")
    out = []
    for i, x in enumerate(bands):
        parts = []
        if i > 0:
            prev = bands[i - 1]
            parts.append(prev.narrow(h_axis, prev.shape[h_axis] - halo, halo)
                         .to(x.device, non_blocking=True))
        elif outer == "zeros":
            parts.append(torch.zeros_like(x.narrow(h_axis, 0, halo)))
        parts.append(x)
        if i < n - 1:
            parts.append(bands[i + 1].narrow(h_axis, 0, halo).to(x.device, non_blocking=True))
        elif outer == "zeros":
            parts.append(torch.zeros_like(x.narrow(h_axis, 0, halo)))
        out.append(torch.cat(parts, dim=h_axis))
    return out


def crop_halo_rows(x: torch.Tensor, halo: int, h_axis: int = 0) -> torch.Tensor:
    """x without ``halo`` rows on both sides of ``h_axis``."""
    return x.narrow(h_axis, halo, x.shape[h_axis] - 2 * halo)


@dataclasses.dataclass
class RowSharded:
    """A tensor of ``height`` rows along ``h_axis`` held as row bands:
    ``bands[b]`` holds global rows ``bounds[b]`` = [r0, r1) on its own
    device. A band may be empty (r0 == r1) where a level has fewer rows
    than there are bands. The row-sharded depth model (``parallel/sp.py``)
    passes its feature maps from layer to layer in this form."""

    bands: list
    bounds: list
    h_axis: int

    @property
    def height(self) -> int:
        return self.bounds[-1][1]

    @property
    def devices(self) -> list:
        return [x.device for x in self.bands]

    def rows(self, a: int, b: int, device) -> torch.Tensor:
        """Global rows [a, b) on ``device``: copied from the bands that own
        them, in band order, with zero rows outside [0, height)."""
        like = next(x for x in self.bands if x.shape[self.h_axis])

        def zeros(n):
            shape = list(like.shape)
            shape[self.h_axis] = n
            return like.new_zeros(shape, device=device)

        parts = [zeros(-a)] if a < 0 else []
        for x, (r0, r1) in zip(self.bands, self.bounds):
            lo, hi = max(a, r0), min(b, r1)
            if lo < hi:
                parts.append(x.narrow(self.h_axis, lo - r0, hi - lo)
                             .to(device, non_blocking=True))
        if b > self.height:
            parts.append(zeros(b - self.height))
        return torch.cat(parts, dim=self.h_axis)

    def gather(self, lead) -> torch.Tensor:
        """The whole tensor on ``lead``."""
        return lead_cat(self.bands, torch.device(lead), self.h_axis)


def lead_sum(parts: list[torch.Tensor], lead: torch.device) -> torch.Tensor:
    """parts[0] + parts[1] + ... on ``lead``, added in list order."""
    total = parts[0].to(lead, non_blocking=True)
    for p in parts[1:]:
        total = total + p.to(lead, non_blocking=True)
    return total


def lead_cat(parts: list[torch.Tensor], lead: torch.device, dim: int = 0) -> torch.Tensor:
    """The parts concatenated along ``dim`` on ``lead``."""
    return torch.cat([p.to(lead, non_blocking=True) for p in parts], dim=dim)


@dataclasses.dataclass(frozen=True)
class BandLayout:
    """A frame of ``height`` x ``width`` in row bands over ``devices`` (band
    b on devices[b]), padded by ``halo`` rows where a band has a neighbour.
    The frame-level results (statistics, the gathered eyes) live on
    ``devices[0]``, the lead."""

    devices: tuple
    bounds: tuple
    halo: int
    width: int

    @classmethod
    def make(cls, height: int, devices, halo: int, width: int) -> "BandLayout":
        devices = tuple(torch.device(d) for d in devices)
        return cls(devices, tuple(band_bounds(height, len(devices), halo)), halo, width)

    @property
    def lead(self) -> torch.device:
        return self.devices[0]

    @property
    def height(self) -> int:
        return self.bounds[-1][1]

    def padded_bounds(self, b: int) -> tuple[int, int]:
        """Band b's rows with its halo: [r0 - top, r1 + bottom)."""
        r0, r1 = self.bounds[b]
        top = self.halo if b > 0 else 0
        bottom = self.halo if b < len(self.bounds) - 1 else 0
        return r0 - top, r1 + bottom

    def split(self, x: torch.Tensor, h_axis: int = 0, padded: bool = False) -> list:
        """Band b's rows of a whole-frame tensor (with their halo when
        ``padded``), each copied to its device."""
        out = []
        for b, dev in enumerate(self.devices):
            r0, r1 = self.padded_bounds(b) if padded else self.bounds[b]
            out.append(x.narrow(h_axis, r0, r1 - r0).to(dev, non_blocking=True))
        return out

    def exchange(self, bands: list[torch.Tensor], h_axis: int = 0) -> list[torch.Tensor]:
        """The bands padded with their neighbours' rows (no outer halo)."""
        return halo_exchange_rows(bands, self.halo, outer="none", h_axis=h_axis)

    def crop(self, padded: list[torch.Tensor], h_axis: int = 0) -> list[torch.Tensor]:
        """Each padded band's own rows."""
        out = []
        for b, x in enumerate(padded):
            r0, r1 = self.bounds[b]
            out.append(x.narrow(h_axis, r0 - self.padded_bounds(b)[0], r1 - r0))
        return out

    def gather(self, bands: list[torch.Tensor], h_axis: int = 0) -> torch.Tensor:
        """The whole frame on the lead device."""
        return lead_cat(bands, self.lead, h_axis)

    def to_devices(self, x: torch.Tensor) -> list[torch.Tensor]:
        """x on every band's device (one copy per distinct device)."""
        copies = {d: x.to(d, non_blocking=True) for d in dict.fromkeys(self.devices)}
        return [copies[d] for d in self.devices]
