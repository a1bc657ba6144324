"""Periodic boxes and minimum-image math (counterpart of mollytpu/boundary.py
and of the box helpers of mollytpu/ops/blockpairs.py:55-129).

Infinite side lengths mark non-periodic axes of an Orthorhombic box, as in
the JAX package. A Triclinic box is a lower-triangular basis whose rows are
the box vectors a = (h11, 0, 0), b = (h21, h22, 0), c = (h31, h32, h33).

Two minimum images live here. ``displacement`` is the JAX package's own
(per-axis rounding; for a Triclinic box fractional rounding, or with
``approx_images=False`` the search of the 27 neighbouring images); ``mic`` is
the pair kernel's back-substitution form over the box's 9-float row
(``mic_row_tensor``: round out the c image, then b, then a). Both give the
shortest image for every pair closer than half the smallest perpendicular
width in a reduced box (a test checks it against 125 images for the boxes
used).

A barostat moves the box on the device: ``scale`` and ``where`` build the
new box from tensors alone, and ``mic_row_tensor`` hands the pair kernel
its row as a device tensor, so no box change waits for the host.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from .config import resolve_device


@dataclasses.dataclass(frozen=True)
class Orthorhombic:
    """Cubic / rectangular box. ``side_lengths`` is a (3,) tensor in nm."""

    side_lengths: torch.Tensor

    def __post_init__(self):
        _init_rows(self)

    def volume(self):
        return torch.prod(self.side_lengths)

    def box_matrix(self):
        return torch.diag(self.side_lengths)

    def _periodic(self):
        box = self.side_lengths
        periodic = torch.isfinite(box)
        return periodic, torch.where(periodic, box, torch.ones_like(box))

    def displacement(self, xi, xj):
        """Minimum-image vector from xi to xj, over (..., 3) tensors."""
        dr = xj - xi
        periodic, safe = self._periodic()
        shift = torch.where(periodic, torch.round(dr / safe),
                            torch.zeros_like(dr))
        return dr - shift * torch.where(periodic, self.side_lengths,
                                        torch.zeros_like(safe))

    def wrap(self, x):
        periodic, safe = self._periodic()
        wrapped = x - torch.floor(x / safe) * safe
        return torch.where(periodic, wrapped, x)

    def fractional(self, x):
        return x / self.side_lengths

    def from_fractional(self, f):
        return f * self.side_lengths

    def reciprocal(self, dtype=None):
        """The inverse of the box matrix, diag(1 / L), as a (3, 3) tensor
        in ``dtype`` (the box's by default), built once per box on its
        device."""
        dtype = dtype or self.side_lengths.dtype
        return _cached(self, ("inv", dtype), lambda: torch.diag(
            1.0 / self.side_lengths.to(dtype)))

    def mic_parts(self, diffs):
        """The JAX package's per-component minimum image
        (mollytpu/boundary.py:86-98) of the raw differences (dx, dy, dz),
        each any shape; an open axis is left alone."""
        safe, mult = _cached(self, "mic", self._mic_consts)
        return tuple(d - torch.round(d / safe[k]) * mult[k]
                     for k, d in enumerate(diffs))

    def _mic_consts(self):
        periodic, safe = self._periodic()
        return safe, torch.where(periodic, self.side_lengths,
                                 torch.zeros_like(safe))

    def mic_tensors(self, dtype=None):
        """The (3,) divisors and image lengths ``mic_parts`` rounds with
        (an open axis: 1 and 0) in ``dtype`` (the box's by default), as
        PyTorch casts them against coordinates of that type; built once
        per box and dtype on its device (no host read)."""
        dtype = dtype or self.side_lengths.dtype
        return _cached(self, ("mic", dtype), lambda: tuple(
            t.detach().to(dtype).contiguous()
            for t in _cached(self, "mic", self._mic_consts)))

    def perp_widths(self):
        """Widths of the cell normal to each face, as Python floats: the
        side lengths (inf for an open axis); read from the device once per
        box."""
        return list(_cached(self, "perp_widths", lambda: [
            float(s) for s in self.side_lengths.tolist()]))

    def _row(self, dtype):
        box = self.side_lengths.to(dtype)
        periodic = torch.isfinite(box)
        side = torch.where(periodic, box, torch.zeros_like(box))
        inv = torch.where(periodic, 1.0 / box, torch.zeros_like(box))
        zero = torch.zeros_like(box[0])
        return torch.stack([side[0], zero, side[1], zero, zero, side[2],
                            inv[0], inv[1], inv[2]])

    def mic_row_tensor(self, dtype=None):
        """The kernel's 9 floats h11, h21, h22, h31, h32, h33, 1/h11, 1/h22,
        1/h33 as a (9,) tensor on the box's device, built there once per
        box and dtype (no host read); an open axis gets side 0 and inverse
        0, so the minimum image leaves it alone."""
        return _cached_row(self, dtype)

    def scale(self, mu):
        """The box scaled by a barostat's mu: a scalar, a (3,) per-axis
        tensor, or a (3, 3) matrix whose diagonal scales the sides."""
        mu = torch.as_tensor(mu, dtype=self.side_lengths.dtype,
                             device=self.side_lengths.device)
        if mu.dim() == 2:
            mu = torch.diagonal(mu)
        return Orthorhombic(self.side_lengths * mu)

    def where(self, cond, other):
        """This box where the 0-d bool tensor ``cond`` holds, else
        ``other``, selected on the device."""
        return Orthorhombic(torch.where(cond, self.side_lengths,
                                        other.side_lengths))

    def to(self, device=None, dtype=None):
        return Orthorhombic(self.side_lengths.to(device=device, dtype=dtype))


@dataclasses.dataclass(frozen=True)
class Triclinic:
    """Triclinic box: ``basis`` is a (3, 3) lower-triangular tensor whose rows
    are the box vectors (a along x, b in the xy plane), as in the JAX
    package. ``displacement`` rounds fractional coordinates, exact for
    pairs closer than half the smallest width of a reduced box; with
    ``approx_images=False`` it searches the 27 neighbouring images for the
    shortest vector (mollytpu/boundary.py:140-160). The flag reaches only
    ``displacement``: ``mic_parts`` and the pair kernel's ``mic`` keep the
    rounding form, as in the JAX package. ``inv`` is the basis's inverse:
    given by ``scale`` and ``where``, which derive it on the device, or
    computed once at construction."""

    basis: torch.Tensor
    inv: torch.Tensor = dataclasses.field(default=None, repr=False,
                                          compare=False)
    approx_images: bool = True

    def __post_init__(self):
        _init_rows(self)
        if self.inv is None:
            # once, on the host in float64: a per-call linalg.inv on the
            # card would wait for its error check every step
            inv = torch.linalg.inv(self.basis.detach().to("cpu",
                                                          torch.float64))
            object.__setattr__(self, "inv", inv.to(self.basis.device,
                                                   self.basis.dtype))

    def volume(self):
        # lower-triangular: the determinant is the diagonal's product
        return torch.abs(torch.prod(torch.diagonal(self.basis)))

    def box_matrix(self):
        return self.basis

    @property
    def side_lengths(self):
        """Diagonal of the basis (the JAX package's bounding sizes)."""
        return torch.diagonal(self.basis)

    def center(self):
        return self.basis.sum(dim=0) / 2

    def fractional(self, x):
        # x = f @ basis  =>  f = x @ inv(basis)
        return x @ self.inv

    def from_fractional(self, f):
        return f @ self.basis

    def reciprocal(self, dtype=None):
        """The inverse of the basis (``inv``) as a (3, 3) tensor in
        ``dtype``: fractional coordinates are x @ reciprocal()."""
        return self.inv if dtype is None else self.inv.to(dtype)

    def displacement(self, xi, xj):
        f = self.fractional(xj - xi)
        dr0 = self.from_fractional(f - torch.round(f))
        if self.approx_images:
            return dr0
        shifts = _cached(self, ("images", dr0.dtype), lambda: (
            _IMAGE_SHIFTS.to(self.basis.device, dr0.dtype)
            @ self.basis.to(dr0.dtype)))
        cands = dr0[..., None, :] + shifts                   # (..., 27, 3)
        idx = torch.argmin((cands * cands).sum(dim=-1), dim=-1)
        return torch.take_along_dim(cands, idx[..., None, None],
                                    dim=-2).squeeze(-2)

    def mic_parts(self, diffs):
        """The JAX package's per-component fractional-rounding minimum
        image (mollytpu/boundary.py:175-190) of (dx, dy, dz)."""
        dx, dy, dz = diffs
        inv, b = self.inv, self.basis
        fs = [dx * inv[0, k] + dy * inv[1, k] + dz * inv[2, k]
              for k in range(3)]
        fs = [f - torch.round(f) for f in fs]
        return tuple(fs[0] * b[0, k] + fs[1] * b[1, k] + fs[2] * b[2, k]
                     for k in range(3))

    def mic_tensors(self, dtype=None):
        """(inv, basis), the (3, 3) matrices ``mic_parts`` rounds with, in
        ``dtype`` (the basis's by default), as PyTorch casts them against
        coordinates of that type; built once per box and dtype on its
        device (no host read)."""
        dtype = dtype or self.basis.dtype
        return _cached(self, ("mic", dtype), lambda: tuple(
            t.detach().to(dtype).contiguous()
            for t in (self.inv, self.basis)))

    def wrap(self, x):
        f = self.fractional(x)
        return self.from_fractional(f - torch.floor(f))

    def perp_widths(self):
        """V / |face area| along each axis normal, as Python floats
        (mollytpu/ops/blockpairs.py:90-104); worked out once per box."""
        def widths():
            h = self.basis.detach().to("cpu", torch.float64)
            vol = abs(float(torch.linalg.det(h)))
            return [vol / float(torch.linalg.vector_norm(torch.linalg.cross(
                h[(k + 1) % 3], h[(k + 2) % 3]))) for k in range(3)]
        return list(_cached(self, "perp_widths", widths))

    def _row(self, dtype):
        h = self.basis.to(dtype)
        d = torch.diagonal(h)
        return torch.cat([h[0, :1], h[1, :2], h[2], 1.0 / d])

    def mic_row_tensor(self, dtype=None):
        """The kernel's 9 floats (mollytpu/ops/blockpairs.py:107-129) as a
        (9,) tensor on the box's device, built there once per box and
        dtype (no host read)."""
        return _cached_row(self, dtype)

    def scale(self, mu):
        """The box scaled by a barostat's mu (JAX boundary.py:164-170): a
        scalar scales the basis, a (3,) tensor its columns (each Cartesian
        axis), a (3, 3) matrix maps it to basis @ mu.T; the matrix must be
        upper triangular, so that the basis stays lower triangular as the
        volume and the kernel's minimum image need. The inverse follows on
        the device: inv / mu, diag(1/mu) inv, or inv(mu.T) @ inv."""
        mu = torch.as_tensor(mu, dtype=self.basis.dtype,
                             device=self.basis.device)
        exact = self.approx_images
        if mu.dim() == 0:
            return Triclinic(self.basis * mu, inv=self.inv / mu,
                             approx_images=exact)
        if mu.dim() == 1:
            return Triclinic(self.basis * mu[None, :],
                             inv=self.inv / mu[:, None], approx_images=exact)
        inv_mu_t, _ = torch.linalg.inv_ex(mu.T)
        return Triclinic(self.basis @ mu.T, inv=inv_mu_t @ self.inv,
                         approx_images=exact)

    def where(self, cond, other):
        """This box where the 0-d bool tensor ``cond`` holds, else
        ``other``, selected on the device."""
        return Triclinic(torch.where(cond, self.basis, other.basis),
                         inv=torch.where(cond, self.inv, other.inv),
                         approx_images=self.approx_images)

    def to(self, device=None, dtype=None):
        return Triclinic(self.basis.to(device=device, dtype=dtype),
                         inv=self.inv.to(device=device, dtype=dtype),
                         approx_images=self.approx_images)


#: the 27 image shifts (-1, 0, 1)^3 in fractional units, in the JAX
#: package's order (mollytpu/boundary.py:154-156)
_IMAGE_SHIFTS = torch.tensor([[a, b, c] for c in (-1, 0, 1)
                              for a in (-1, 0, 1) for b in (-1, 0, 1)],
                             dtype=torch.float64)


def _init_rows(box):
    object.__setattr__(box, "_rows", {})


def _cached_row(box, dtype):
    dtype = dtype or box.side_lengths.dtype
    return _cached(box, dtype, lambda: box._row(dtype))


def _cached(box, key, make):
    """make(), built once per box (boxes are immutable: a barostat move
    makes a new one)."""
    value = box._rows.get(key)
    if value is None:
        value = box._rows[key] = make()
    return value


def mic(row, dx, dy, dz):
    """Back-substitution minimum image of the components dx, dy, dz (any
    shape) over a 9-entry ``row`` (floats or 0-d tensors) laid out as
    ``mic_row_tensor``: round out the c image, then b, then a. With zero
    off-diagonals this is per-axis rounding."""
    h11, h21, h22, h31, h32, h33, ih11, ih22, ih33 = row
    s3 = torch.round(dz * ih33)
    dx = dx - s3 * h31
    dy = dy - s3 * h32
    dz = dz - s3 * h33
    s2 = torch.round(dy * ih22)
    dx = dx - s2 * h21
    dy = dy - s2 * h22
    dx = dx - torch.round(dx * ih11) * h11
    return dx, dy, dz


def pair_geometry(coords, boundary, js=None):
    """Per-component minimum image dr[d][i, c] = x_j - x_i by the box's
    ``mic_parts``, and r^2 = dx^2 + dy^2 + dz^2 in that order, over all j
    (js None: (N, N)) or the table columns js (N, K) of each row atom."""
    comps = [coords[:, k] for k in range(coords.shape[1])]
    if js is None:
        diffs = tuple(c[None, :] - c[:, None] for c in comps)
    else:
        diffs = tuple(c[js] - c[:, None] for c in comps)
    drs = boundary.mic_parts(diffs)
    return drs, drs[0] * drs[0] + drs[1] * drs[1] + drs[2] * drs[2]


def mic_displacement(boundary, xi, xj):
    """The pair kernel's minimum-image vector from xi to xj, (..., 3)."""
    dr = xj - xi
    row = boundary.mic_row_tensor(dr.dtype).to(dr.device)
    return torch.stack(mic(row, dr[..., 0], dr[..., 1], dr[..., 2]), dim=-1)


def cubic(side, dtype=torch.float32, device=None):
    """Same side length (nm) on all three axes."""
    return Orthorhombic(torch.full((3,), float(side), dtype=dtype,
                                   device=resolve_device(device)))


def rectangular(sides, dtype=torch.float32, device=None):
    return Orthorhombic(torch.as_tensor(sides, dtype=dtype,
                                        device=resolve_device(device)))


def triclinic(basis, dtype=torch.float32, device=None, approx_images=True):
    """A Triclinic box from a (3, 3) lower-triangular basis (rows = box
    vectors, nm)."""
    return Triclinic(torch.as_tensor(basis, dtype=dtype,
                                     device=resolve_device(device)),
                     approx_images=approx_images)


def triclinic_from_lengths_angles(lengths, angles, dtype=torch.float32,
                                  device=None):
    """Reduced triclinic basis from (a, b, c) in nm and (alpha, beta, gamma)
    in radians, as mollytpu.boundary.triclinic_from_lengths_angles."""
    a, b, c = (float(v) for v in lengths)
    al, be, ga = (float(v) for v in angles)
    cx = c * math.cos(be)
    cy = c * (math.cos(al) - math.cos(be) * math.cos(ga)) / math.sin(ga)
    cz = math.sqrt(max(c * c - cx * cx - cy * cy, 0.0))
    return triclinic([[a, 0.0, 0.0],
                      [b * math.cos(ga), b * math.sin(ga), 0.0],
                      [cx, cy, cz]], dtype=dtype, device=device)


def random_coords(generator, boundary, n, dtype=torch.float32):
    """n uniform random positions in the box, drawn on the box's device
    from ``generator``."""
    device = boundary.side_lengths.device
    f = torch.rand((n, 3), generator=generator, dtype=dtype, device=device)
    return boundary.from_fractional(f)


def place_atoms(generator, boundary, n, min_dist=0.0, max_attempts=100,
                dtype=torch.float32):
    """n positions, each at least min_dist (nm, minimum image) from those
    placed before it, rejection-sampled one at a time
    (mollytpu/boundary.py:248-272). A setup-time helper: it reads every
    draw on the host."""
    min2 = float(min_dist) ** 2
    coords = []
    for i in range(n):
        for _ in range(max_attempts):
            c = random_coords(generator, boundary, 1, dtype=dtype)[0]
            if not coords or min2 == 0.0:
                break
            dr = boundary.displacement(torch.stack(coords), c[None, :])
            if bool(torch.all((dr * dr).sum(dim=-1) > min2)):
                break
        else:
            raise RuntimeError(f"place_atoms: could not place atom {i} "
                               f"after {max_attempts} attempts")
        coords.append(c)
    return torch.stack(coords)


def place_diatomics(generator, boundary, n_molecules, bond_length,
                    min_dist=0.0, max_attempts=100, dtype=torch.float32):
    """n_molecules diatomics: place_atoms for the first atoms, each second
    atom bond_length (nm) along x from its first, wrapped; the atoms of
    molecule m are 2m and 2m + 1 (mollytpu/boundary.py:275-285)."""
    first = place_atoms(generator, boundary, n_molecules, min_dist=min_dist,
                        max_attempts=max_attempts, dtype=dtype)
    second = first.clone()
    second[:, 0] += bond_length
    return boundary.wrap(torch.stack([first, second], dim=1).reshape(-1, 3))


def displacement_fn(boundary):
    """The pairwise displacement function closed over ``boundary``
    (mollytpu/boundary.py:222-228)."""

    def disp(xi, xj):
        return boundary.displacement(xi, xj)

    return disp


def distance(boundary, xi, xj):
    """Minimum-image distance |x_j - x_i| (mollytpu/boundary.py:231-233)."""
    dr = boundary.displacement(xi, xj)
    return torch.sqrt(torch.sum(dr * dr, dim=-1))


def sq_distance(boundary, xi, xj):
    """Minimum-image squared distance (mollytpu/boundary.py:236-238)."""
    dr = boundary.displacement(xi, xj)
    return torch.sum(dr * dr, dim=-1)
