"""Nonbonded pair forces over the cluster-pair list: the hand-written CUDA
kernel K1 (csrc/pair_nonbonded.cu), its plain PyTorch twin, and the torch
glue around them (counterpart of mollytpu/ops/pallas_pairwise.py:
FusedSpec, build_fused_spec, _pair_terms, _pair_terms_alch,
pallas_block_nonbonded and _far_pair_corrections).

``pair_nonbonded`` dispatches on the device of its inputs: CPU tensors go to
``pair_nonbonded_plain``, CUDA tensors to the kernel, whose launches
``native.LAUNCHES["pair_nonbonded"]`` counts, per compiled instance family
``INSTANCE_LAUNCHES``, and those with energy and virial per family
``ENERGY_LAUNCHES``. There is no fallback between the two.

Every mode of the TPU kernel is ported: LJ with no / distance /
shifted-potential / shifted-force cutoff (lj_mode 4 / 1 / 2 / 3, or 0 for
none) plus plain, reaction-field or Ewald real-space Coulomb (coul_mode
1 / 2 / 3, or 0 for none), 1-4 weights, orthorhombic and triclinic boxes
(K1a, K1b); and the alchemical path (K1c): Beutler or Gapsys soft-core LJ
(lj_kind 1 / 2) and soft-core Coulomb (coul_sc 1 / 2, bare or under the
Ewald screen) with per-pair lambda from per-atom (lambda, role) rows and a
scheduler, and the scaled-charge family (scale_q), whose charges are
scaled per call before the kernel.

So are the TPU kernel's roofline probes (MOLLYTPU_PAIR_VARIANT there),
here an explicit ``probe`` keyword that no main path passes; each is wrong
physics on purpose: ``preponly`` (kernel_inputs runs, no launch),
``nogather`` (kernel_inputs skips the per-step coordinate gather),
``gather_only`` (the kernel loads the tile rows and computes nothing: zero
forces), ``distance_only`` (coef = r^2 * 1e-12 on live slots, no pair
terms) and ``noocc`` (full pair terms, no j-side forces of cross tiles).
The kernel probes have CUDA instances for forces-only Ewald launches in an
orthorhombic box, with and without lambda.
"""

from __future__ import annotations

import collections
import ctypes
import dataclasses
import math

import torch

from . import native
from ..boundary import mic
from ..config import atom_tensors, tracks_grad
from ..free_energy.alchemy import SCHEDULER_IDS, scaled_charge
from .blockpairs import CLUSTER
from .cutoffs import (DistanceCutoff, NoCutoff, ShiftedForceCutoff,
                      ShiftedPotentialCutoff)
from .mixing import GeometricMixing, LorentzMixing, MinimumMixing
from .pairwise import (Coulomb, CoulombEwald, CoulombEwaldScaled,
                       CoulombReactionField, CoulombReactionFieldScaled,
                       CoulombScaled, CoulombSoftCoreBeutler,
                       CoulombSoftCoreBeutlerEwald,
                       CoulombSoftCoreBeutlerReactionField,
                       CoulombSoftCoreGapsys, CoulombSoftCoreGapsysEwald,
                       CoulombSoftCoreGapsysReactionField, LennardJones,
                       LennardJonesSoftCoreBeutler,
                       LennardJonesSoftCoreGapsys, rf_constants)

#: the kernel's launches (native.LAUNCHES["pair_nonbonded"]) per compiled
#: instance family (``instance_family``; a kernel probe's launches under
#: "<family>+<probe>")
INSTANCE_LAUNCHES = collections.Counter()
#: the launches of INSTANCE_LAUNCHES that computed energy and virial
ENERGY_LAUNCHES = collections.Counter()
#: the stream of the last launch, per device: the box row goes into one
#: module-wide __constant__ buffer, written on the launch's stream right
#: before the kernel (launch_args orders a launch on another stream after
#: the launches already queued)
_LAST_STREAM = {}


def reset_launch_counts():
    """Set the kernel's launch counts to 0 (main-path accounting)."""
    native.LAUNCHES["pair_nonbonded"] = 0
    INSTANCE_LAUNCHES.clear()
    ENERGY_LAUNCHES.clear()


class _Launch(ctypes.Structure):
    """The launcher's spec, field for field csrc/pair_nonbonded.cu's
    LaunchSpec (4-byte fields only, so no padding on either side)."""

    _fields_ = [(name, ctypes.c_int) for name in (
        "n_pairs", "n_atoms", "lj_mode", "coul_mode", "triclinic",
        "compute_energy")] + [
        (name, ctypes.c_float) for name in (
            "cut2", "lj_rc2", "coul_rc2", "lj_rc", "inv_lj_rc",
            "inv_lj_rc2", "lj_w", "coul_w", "ke", "alpha", "krf", "crf")] + [
        (name, ctypes.c_int) for name in (
            "use_lam", "lj_kind", "coul_sc", "scheduler")] + [
        (name, ctypes.c_float) for name in (
            "lj_alpha", "coul_alpha_sc", "coul_sigma_q")] + [
        ("probe", ctypes.c_int)]


_SIG = {"pair_nonbonded_launch": [ctypes.c_void_p] * 11}

#: the roofline probes: the kernel instances' ids (LaunchSpec.probe), and
#: every probe name the ``probe`` keywords take
KERNEL_PROBES = {"gather_only": 1, "distance_only": 2, "noocc": 3}
PROBES = ("preponly", "nogather", *KERNEL_PROBES)


def _check_probe(probe):
    if probe and probe not in PROBES:
        raise ValueError(f"unknown probe {probe!r}: one of {PROBES}")


@dataclasses.dataclass(frozen=True)
class FusedSpec:
    """Static description of the fused pair interaction
    (mollytpu/ops/pallas_pairwise.py:50-89)."""

    lj_mode: int = 0      # 0 none, 1 distance, 2 shifted potential,
                          # 3 shifted force, 4 no cutoff
    lj_rc: float = 0.0
    lj_w: float = 1.0     # LJ weight of 1-4 pairs
    coul_mode: int = 0    # 0 none, 1 plain, 2 reaction field, 3 Ewald real
    coul_rc: float = 0.0  # 0 for plain Coulomb without a cutoff
    ke: float = 0.0
    krf: float = 0.0
    crf: float = 0.0
    alpha: float = 0.0
    coul_w: float = 1.0   # Coulomb weight of 1-4 pairs
    cut_max: float = 1.0  # every pair beyond it is skipped
    # alchemical path: lj_kind 0 plain, 1 Beutler, 2 Gapsys soft-core LJ;
    # coul_sc 0 none, 1 Beutler, 2 Gapsys soft-core Coulomb (with coul_mode
    # 1 bare, 3 under the Ewald screen); scale_q: charges scaled by the
    # scheduler's scale_elec before the kernel (the Scaled Coulomb family)
    lj_kind: int = 0
    lj_alpha: float = 0.0
    coul_sc: int = 0
    coul_alpha_sc: float = 0.0
    coul_sigma_q: float = 0.0
    scale_q: bool = False
    scheduler: object = None

    @property
    def needs_lam(self):
        """Per-atom (lambda, role) rows must reach the kernel."""
        return self.lj_kind != 0 or self.coul_sc != 0

    @property
    def lj_masked(self):
        """LJ needs its own r < lj_rc test inside cut_max."""
        return self.lj_mode in (1, 2, 3) and self.lj_rc < self.cut_max

    @property
    def coul_masked(self):
        """Coulomb needs its own r < coul_rc test inside cut_max."""
        return bool(self.coul_mode) and 0.0 < self.coul_rc < self.cut_max


_LJ_MODES = {NoCutoff: 4, DistanceCutoff: 1, ShiftedPotentialCutoff: 2,
             ShiftedForceCutoff: 3}
_LJ_KINDS = {LennardJones: 0, LennardJonesSoftCoreBeutler: 1,
             LennardJonesSoftCoreGapsys: 2}
_COULOMBS = (Coulomb, CoulombReactionField, CoulombEwald, CoulombScaled,
             CoulombReactionFieldScaled, CoulombEwaldScaled,
             CoulombSoftCoreBeutler, CoulombSoftCoreGapsys,
             CoulombSoftCoreBeutlerEwald, CoulombSoftCoreGapsysEwald)


def build_fused_spec(inters):
    """Map pairwise interactions onto a FusedSpec, as build_fused_spec of
    the JAX package does for them. What the kernel does not cover, and
    every case the JAX package refuses, raises NotImplementedError naming
    the reason."""
    spec = dict(lj_mode=0, lj_rc=0.0, lj_w=1.0, coul_mode=0, coul_rc=0.0,
                ke=0.0, krf=0.0, crf=0.0, alpha=0.0, coul_w=1.0,
                lj_kind=0, lj_alpha=0.0, coul_sc=0, coul_alpha_sc=0.0,
                coul_sigma_q=0.0, scale_q=False, scheduler=None)
    cut_max = 0.0

    def alchemical(inter, name):
        """The lambda mixing and the one scheduler of the spec."""
        if not isinstance(inter.lambda_mixing, MinimumMixing):
            raise NotImplementedError(
                f"{name}: lambda mixing {type(inter.lambda_mixing).__name__}"
                " is not a mode of the pair kernel (MinimumMixing only)")
        scheduled(inter, name)

    def scheduled(inter, name):
        if type(inter.scheduler) not in SCHEDULER_IDS:
            raise NotImplementedError(
                f"{name}: scheduler {type(inter.scheduler).__name__} is not "
                "one the pair kernel evaluates")
        if spec["scheduler"] is None:
            spec["scheduler"] = inter.scheduler
        elif type(spec["scheduler"]) is not type(inter.scheduler):
            raise NotImplementedError(
                f"{name}: two lambda schedulers of different types "
                f"({type(spec['scheduler']).__name__} and "
                f"{type(inter.scheduler).__name__}); the kernel resolves "
                "one per launch")

    def plain_cutoff(inter, name):
        """Coulomb radius of a NoCutoff / DistanceCutoff (0 for none)."""
        if not isinstance(inter.cutoff, (NoCutoff, DistanceCutoff)):
            what = ("soft-core Coulomb" if "SoftCore" in name else "Coulomb")
            raise NotImplementedError(
                f"{name}: {what} with {type(inter.cutoff).__name__}: only "
                "no cutoff or a distance cutoff is a mode of the pair kernel")
        return (float(inter.cutoff.dist_cutoff)
                if isinstance(inter.cutoff, DistanceCutoff) else 0.0)

    for inter in inters:
        name = type(inter).__name__
        if type(inter) in _LJ_KINDS:
            if spec["lj_mode"]:
                raise NotImplementedError("two Lennard-Jones interactions")
            if not (isinstance(inter.sigma_mixing, LorentzMixing)
                    and isinstance(inter.epsilon_mixing, GeometricMixing)):
                raise NotImplementedError(
                    "only Lorentz-Berthelot mixing is a mode of the pair "
                    "kernel (NBFix and the other rules run on the neighbor "
                    "engine)")
            mode = _LJ_MODES.get(type(inter.cutoff))
            if mode is None:
                raise NotImplementedError(
                    f"LJ cutoff {type(inter.cutoff).__name__} is not a mode "
                    "of the pair kernel")
            rc = 0.0 if mode == 4 else float(inter.cutoff.dist_cutoff)
            kind = _LJ_KINDS[type(inter)]
            if kind:
                alchemical(inter, name)
                if not rc:
                    raise NotImplementedError(
                        f"{name} without a finite cutoff: the soft-core "
                        "path needs one for the list")
                spec.update(lj_kind=kind, lj_alpha=float(inter.alpha))
            spec.update(lj_mode=mode, lj_rc=rc,
                        lj_w=float(inter.weight_special))
            cut_max = max(cut_max, rc)
            continue
        if isinstance(inter, (CoulombSoftCoreBeutlerReactionField,
                              CoulombSoftCoreGapsysReactionField)):
            raise NotImplementedError(
                f"pairwise interaction {name}: soft-core Coulomb under the "
                "reaction field is not a mode of the pair kernel; the JAX "
                "package runs it on its XLA pair path (its build_fused_spec "
                "returns None), and so does the port (ops/nonbonded.py)")
        if not isinstance(inter, _COULOMBS):
            raise NotImplementedError(
                f"pairwise interaction {name}: not a mode of the pair kernel")
        if spec["coul_mode"]:
            raise NotImplementedError("two Coulomb interactions")
        common = dict(ke=float(inter.coulomb_const),
                      coul_w=float(inter.weight_special))
        if isinstance(inter, (Coulomb, CoulombScaled)):
            spec.update(coul_mode=1, coul_rc=plain_cutoff(inter, name),
                        **common)
        elif isinstance(inter, (CoulombReactionField,
                                CoulombReactionFieldScaled)):
            rc = float(inter.dist_cutoff)
            krf, crf = rf_constants(rc, float(inter.solvent_dielectric))
            spec.update(coul_mode=2, coul_rc=rc, krf=krf, crf=crf, **common)
        elif isinstance(inter, (CoulombEwald, CoulombEwaldScaled)):
            spec.update(coul_mode=3, coul_rc=float(inter.dist_cutoff),
                        alpha=float(inter.alpha), **common)
        elif isinstance(inter, (CoulombSoftCoreBeutler,
                                CoulombSoftCoreGapsys)):
            alchemical(inter, name)
            if (isinstance(inter, CoulombSoftCoreBeutler)
                    and not isinstance(inter.sigma_mixing, LorentzMixing)):
                raise NotImplementedError(
                    f"{name}: only Lorentz sigma mixing is ported")
            rc = plain_cutoff(inter, name)
            if not rc:
                raise NotImplementedError(
                    f"{name} without a finite cutoff: the soft-core path "
                    "needs one for the list")
            spec.update(coul_mode=1, coul_rc=rc, **common,
                        coul_sc=1 if isinstance(
                            inter, CoulombSoftCoreBeutler) else 2,
                        coul_alpha_sc=float(inter.alpha),
                        coul_sigma_q=float(getattr(inter, "sigma_q", 0.0)))
        else:   # soft-core Ewald
            alchemical(inter, name)
            beutler = isinstance(inter, CoulombSoftCoreBeutlerEwald)
            if beutler and not isinstance(inter.sigma_mixing, LorentzMixing):
                raise NotImplementedError(
                    f"{name}: only Lorentz sigma mixing is ported")
            spec.update(coul_mode=3, coul_rc=float(inter.dist_cutoff),
                        alpha=float(inter.alpha), **common,
                        coul_sc=1 if beutler else 2,
                        coul_alpha_sc=float(inter.alpha_sc),
                        coul_sigma_q=float(getattr(inter, "sigma_q", 0.0)))
        if "Scaled" in name:
            scheduled(inter, name)
            spec["scale_q"] = True
        cut_max = max(cut_max, spec["coul_rc"])
    if not spec["lj_mode"] and not spec["coul_mode"]:
        raise NotImplementedError("no interaction for the pair kernel")
    if cut_max == 0.0:
        raise NotImplementedError(
            "no finite cutoff: the pair kernel needs one; interactions "
            "without a list (use_neighbors=False) run the dense engine")
    return FusedSpec(cut_max=cut_max, **spec)


def instance_family(spec, boundary):
    """The kernel instance family a launch runs: the lambda template, the
    Coulomb template and the box template (the energy template is the
    caller's choice)."""
    box = "triclinic" if getattr(boundary, "basis", None) is not None \
        else "ortho"
    lam = "lam-" if spec.needs_lam else ""
    return f"{lam}coul{spec.coul_mode}-{box}"


def _pair_terms(spec, r2, sig, eps, qq, special):
    """(energy, coef = (dU/dr)/r) for r2 > 0 inside cut_max, following
    mollytpu/ops/pallas_pairwise.py:462-555 term by term (Ewald with the
    exact erfc): per-term lj_rc / coul_rc masks inside cut_max, LJ times
    lj_w for 1-4 pairs, and plain Coulomb times coul_w for 1-4 pairs under
    the reaction field and Ewald."""
    inv_r = 1.0 / torch.sqrt(r2)
    inv_r2 = inv_r * inv_r
    r = r2 * inv_r
    zero = torch.zeros_like(r2)
    e, coef = zero, zero
    if spec.lj_mode:
        s2 = sig * sig * inv_r2
        six = s2 * s2 * s2
        twelve = six * six
        e_lj = 4.0 * eps * (twelve - six)
        c_lj = -24.0 * eps * (2.0 * twelve - six) * inv_r2
        if spec.lj_mode in (2, 3):
            rc = spec.lj_rc
            s2c = sig * sig / (rc * rc)
            sixc = s2c * s2c * s2c
            twelvec = sixc * sixc
            e_lj = e_lj - 4.0 * eps * (twelvec - sixc)
            if spec.lj_mode == 3:
                dudr_rc = -24.0 * eps * (2.0 * twelvec - sixc) / rc
                e_lj = e_lj - (r - rc) * dudr_rc
                c_lj = c_lj - dudr_rc * inv_r
        # hydrogens carry eps = 0: select (not multiply) so 0 * inf never
        # reaches the sum
        on = eps != 0
        if spec.lj_masked:
            on = on & (r2 < spec.lj_rc * spec.lj_rc)
        wl = torch.where(special, torch.full_like(r2, spec.lj_w),
                         torch.ones_like(r2))
        e = torch.where(on, e_lj * wl, zero)
        coef = torch.where(on, c_lj * wl, zero)
    if spec.coul_mode:
        keqq = spec.ke * qq
        e_plain = keqq * inv_r
        c_plain = -keqq * inv_r2 * inv_r
        if spec.coul_mode == 1:
            wc = torch.where(special, torch.full_like(r2, spec.coul_w),
                             torch.ones_like(r2))
            e_c, c_c = e_plain * wc, c_plain * wc
        else:
            if spec.coul_mode == 2:
                e_f = keqq * (inv_r + spec.krf * r2 - spec.crf)
                c_f = keqq * (-inv_r2 * inv_r + 2.0 * spec.krf)
            else:
                ar = spec.alpha * r
                erfc_ar = torch.special.erfc(ar)
                e_f = keqq * erfc_ar * inv_r
                c_f = -keqq * inv_r2 * (erfc_ar * inv_r + 2.0 * spec.alpha
                                        / math.sqrt(math.pi)
                                        * torch.exp(-ar * ar))
            e_c = torch.where(special, e_plain * spec.coul_w, e_f)
            c_c = torch.where(special, c_plain * spec.coul_w, c_f)
        if spec.coul_masked:
            inside = r2 < spec.coul_rc * spec.coul_rc
            e_c = torch.where(inside, e_c, zero)
            c_c = torch.where(inside, c_c, zero)
        e, coef = e + e_c, coef + c_c
    return e, coef


def _soft_lj_terms(spec, sig, eps, lam_s):
    """rr2 -> (energy, coef) of the soft-core LJ at lambda_s: Beutler,
    R6 = alpha (1 - l) sigma^6 + r^6 floored at 1e-12, or Gapsys, the plain
    potential beyond r_LJ and its quadratic expansion inside
    (pallas_pairwise.py:332-378)."""
    sig2 = sig * sig
    sig6 = sig2 * sig2 * sig2
    c6 = 4.0 * eps * sig6
    c12 = c6 * sig6
    if spec.lj_kind == 1:
        shift = spec.lj_alpha * (1.0 - lam_s) * sig6

        def terms(rr2):
            r6 = torch.clamp(shift + rr2 * rr2 * rr2, min=1e-12)
            inv6 = 1.0 / r6
            return (lam_s * (c12 * inv6 - c6) * inv6,
                    6.0 * lam_s * rr2 * rr2 * (c6 - 2.0 * c12 * inv6)
                    * inv6 * inv6)
        return terms
    tiny = 1e-30
    ratio = torch.where(c6 > 0, 26.0 * c12 * (1.0 - lam_s)
                        / (7.0 * torch.clamp(c6, min=tiny)), 0.0)
    # r_LJ = alpha ratio^(1/6) through exp(log(.) / 6), as the kernel
    r_lj = spec.lj_alpha * torch.where(
        ratio > 0, torch.exp(torch.log(torch.clamp(ratio, min=tiny)) / 6.0),
        0.0)
    rs = torch.clamp(r_lj, min=1e-6)
    inv_rs = 1.0 / rs
    inv_rs2 = 1.0 / (rs * rs)
    inv_rs6 = inv_rs2 * inv_rs2 * inv_rs2
    inv_rs12 = inv_rs6 * inv_rs6
    a = 78.0 * c12 * inv_rs12 * inv_rs2 - 21.0 * c6 * inv_rs6 * inv_rs2
    b = 168.0 * c12 * inv_rs12 * inv_rs - 48.0 * c6 * inv_rs6 * inv_rs
    c = 91.0 * c12 * inv_rs12 - 28.0 * c6 * inv_rs6

    def terms(rr2):
        rr2s = torch.clamp(rr2, min=1e-12)
        rr = torch.sqrt(rr2s)
        inv2 = 1.0 / rr2s
        inv6 = inv2 * inv2 * inv2
        inv12 = inv6 * inv6
        outer = rr >= r_lj
        e_in = (a * rr2s - b * rr) + c
        c_in = 2.0 * a - b / rr
        return (lam_s * torch.where(outer, c12 * inv12 - c6 * inv6, e_in),
                lam_s * torch.where(
                    outer, -(12.0 * c12 * inv12 - 6.0 * c6 * inv6) * inv2,
                    c_in))
    return terms


def _pair_terms_alch(spec, r2, sig, eps, qq, special, lam_s, lam_e):
    """(energy, coef) of the alchemical path at the per-pair scales lam_s
    (sterics) and lam_e (electrostatics), following
    mollytpu/ops/pallas_pairwise.py:320-459 term by term: soft-core LJ
    (its own cutoff, shifts at rc with the same lam_s, live where lam_s > 0
    and eps != 0) or plain LJ, and soft-core Coulomb (live where lam_e > 0;
    under Ewald the Abramowitz-Stegun erfc times exp(-(alpha r)^2) on the
    true r, 1-4 pairs unscreened times coul_w) or plain Coulomb."""
    inv_r = 1.0 / torch.sqrt(r2)
    r = r2 * inv_r
    zero = torch.zeros_like(r2)
    e, coef = zero, zero
    if spec.lj_mode and spec.lj_kind:
        terms = _soft_lj_terms(spec, sig, eps, lam_s)
        e_lj, c_lj = terms(r2)
        if spec.lj_mode in (2, 3):
            rc = spec.lj_rc
            e_rc, c_rc = terms(torch.full_like(r2, rc * rc))
            e_lj = e_lj - e_rc
            if spec.lj_mode == 3:
                dudr_rc = c_rc * rc
                e_lj = e_lj - (r - rc) * dudr_rc
                c_lj = c_lj - dudr_rc * inv_r
        on = (lam_s > 0) & (eps != 0)
        if spec.lj_mode != 4:
            on = on & (r2 < spec.lj_rc * spec.lj_rc)
        wl = torch.where(special, torch.full_like(r2, spec.lj_w),
                         torch.ones_like(r2))
        e = torch.where(on, e_lj * wl, zero)
        coef = torch.where(on, c_lj * wl, zero)
    elif spec.lj_mode:
        e, coef = _pair_terms(dataclasses.replace(spec, coul_mode=0), r2,
                              sig, eps, qq, special)
    if spec.coul_mode and spec.coul_sc:
        keqq = spec.ke * qq
        if spec.coul_sc == 1:
            sig2 = sig * sig
            sig6 = sig2 * sig2 * sig2
            shift = spec.coul_alpha_sc * (1.0 - lam_e) * sig6
            rq = torch.clamp(shift + r2 * r2 * r2, min=1e-18)
            p = torch.exp(-torch.log(rq) / 6.0)            # rq^(-1/6)
            base_e = lam_e * keqq * p
            base_c = -lam_e * keqq * r2 * r2 * p / rq
        else:
            rq = spec.coul_alpha_sc * torch.exp(torch.log(torch.clamp(
                1.0 - lam_e, min=1e-30)) / 6.0) * (
                    1.0 + spec.coul_sigma_q * torch.abs(qq))
            rq = torch.where(lam_e < 1.0, rq, 0.0)
            rqs = torch.clamp(rq, min=1e-9)
            inv_rq = 1.0 / rqs
            inv_rq2 = inv_rq * inv_rq
            inv_rq3 = inv_rq2 * inv_rq
            outer = r >= rq
            base_e = lam_e * torch.where(
                outer, keqq * inv_r,
                keqq * (inv_rq3 * r2 - 3.0 * inv_rq2 * r + 3.0 * inv_rq))
            base_c = lam_e * torch.where(
                outer, -keqq * inv_r * inv_r * inv_r,
                keqq * (2.0 * inv_rq3 - 3.0 * inv_rq2 * inv_r))
        if spec.coul_mode == 3:
            ar = spec.alpha * r
            t = 1.0 / (1.0 + 0.3275911 * ar)
            poly = (0.254829592 + (-0.284496736 + (1.421413741 + (
                -1.453152027 + 1.061405429 * t) * t) * t) * t) * t
            exp_m = torch.exp(-ar * ar)
            erfc_ar = poly * exp_m
            derfc_r = -2.0 * spec.alpha / math.sqrt(math.pi) * exp_m * inv_r
            e_c = torch.where(special, base_e * spec.coul_w, base_e * erfc_ar)
            c_c = torch.where(special, base_c * spec.coul_w,
                              base_c * erfc_ar + base_e * derfc_r)
        else:
            wc = torch.where(special, torch.full_like(r2, spec.coul_w),
                             torch.ones_like(r2))
            e_c, c_c = base_e * wc, base_c * wc
        on = lam_e > 0
        if spec.coul_rc:
            on = on & (r2 < spec.coul_rc * spec.coul_rc)
        e = e + torch.where(on, e_c, zero)
        coef = coef + torch.where(on, c_c, zero)
    elif spec.coul_mode:
        e1, c1 = _pair_terms(dataclasses.replace(spec, lj_mode=0), r2, sig,
                             eps, qq, special)
        e, coef = e + e1, coef + c1
    return e, coef


def pair_lambdas(spec, lam_i, lam_j, role_i, role_j):
    """Per-pair (lam_s, lam_e), the kernel's lambda block
    (pallas_pairwise.py:814-840): the minimum of the two lambdas through
    the scheduler at the pair role (INSERT dominates, then DELETE), fully
    on for two atoms of the same non-core role, and no LJ where either
    atom's lambda is exactly 0. Roles ride as floats."""
    lam_mix = torch.minimum(lam_i, lam_j)
    same_noncore = (role_i == role_j) & (role_i != 0.0)
    pair_role = torch.where((role_i == 1.0) | (role_j == 1.0), 1.0,
                            torch.where((role_i == 2.0) | (role_j == 2.0),
                                        2.0, 0.0)).to(lam_mix.dtype)
    sched = spec.scheduler
    lam_s = torch.where(same_noncore, 1.0,
                        sched.scale_sterics(lam_mix, pair_role))
    lam_e = torch.where(same_noncore, 1.0,
                        sched.scale_elec(lam_mix, pair_role))
    lam_live = (lam_i != 0.0) & (lam_j != 0.0)
    return torch.where(lam_live, lam_s, 0.0), lam_e


def _atom_lambda_rows(atoms, dtype):
    """(N, 2) rows of (lambda, role) in atom order; lambda 1 and CORE where
    the atoms carry none."""
    n, dev = atoms.mass.shape[0], atoms.mass.device
    lam = (atoms.lam if atoms.lam is not None
           else torch.ones(n, dtype=dtype, device=dev))
    role = (atoms.alch_role if atoms.alch_role is not None
            else torch.zeros(n, dtype=torch.int32, device=dev))
    return torch.stack([lam.to(dtype), role.to(dtype)], dim=1)


def lambda_rows(atoms, blockpairs):
    """(n_pad, 2) rows of (lambda, role) per sorted slot, zero for padding,
    in the slots' dtype: gathered per call, since lambda changes between
    calls on one list (the TPU kernel's a_lr / j_lr,
    pallas_pairwise.py:1057-1070)."""
    rows = _atom_lambda_rows(atoms, blockpairs.pos4.dtype)
    real = (blockpairs.ids < rows.shape[0])[:, None]
    return torch.where(real, rows[blockpairs.src], 0.0).contiguous()


def _tile_geometry(spec, row, xi, xj, idi, idj, bi, n_atoms):
    """Per-slot geometry of a batch of 32 x 32 tiles: xi (T, 32, 3), idi
    (T, 32), bi (T, 32, 4); returns dx = xj - xi under the kernel's
    back-substitution minimum image (T, 32, 32, 3), r2, and the live and
    1-4 masks (T, 32, 32)."""
    d = xj[:, None, :, :] - xi[:, :, None, :]
    dx = torch.stack(mic(row, d[..., 0], d[..., 1], d[..., 2]), dim=-1)
    r2 = (dx * dx).sum(dim=-1)
    id_i = idi[:, :, None]
    id_j = idj[:, None, :]
    # exclusion bits live in atom-id space: offset d = id_j - id_i + 32
    off = id_j - id_i + 32
    in_win = (off >= 0) & (off < 64)
    sh = off & 31
    lo = off < 32
    ew = torch.where(lo, bi[:, :, 0:1], bi[:, :, 1:2])
    sw = torch.where(lo, bi[:, :, 2:3], bi[:, :, 3:4])
    excl = in_win & (((ew >> sh) & 1) != 0)
    special = in_win & (((sw >> sh) & 1) != 0)
    live = ((id_i != id_j) & (id_i < n_atoms) & (id_j < n_atoms)
            & (r2 < spec.cut_max ** 2) & ~excl)
    return dx, r2, live, special


def _tiles(blockpairs, boundary, chunk):
    """Per-cluster views of the packed rows, the call's box row (the
    kernel's ``mic`` buffer) and the cluster pairs in chunks of
    ``chunk``."""
    pos4 = blockpairs.pos4
    row = boundary.mic_row_tensor(pos4.dtype).to(pos4.device)
    x = pos4[:, :3].view(-1, CLUSTER, 3)
    par = torch.cat([blockpairs.lj2, pos4[:, 3:4]], dim=1).view(
        -1, CLUSTER, 3)
    idc = blockpairs.ids.to(torch.int64).view(-1, CLUSTER)
    bitc = blockpairs.bits.view(-1, CLUSTER, 4)
    pairs = blockpairs.pairs.to(torch.int64)
    chunks = [pairs[s:s + chunk].unbind(dim=1)
              for s in range(0, pairs.shape[0], chunk)]
    return row, x, par, idc, bitc, chunks


def pair_nonbonded_plain(spec, blockpairs, boundary, n_atoms,
                         compute_energy=False, lam_role=None, chunk=1024,
                         probe=""):
    """Plain PyTorch twin of the kernel: every listed 32 x 32 tile at once
    (in chunks of ``chunk`` tiles to bound memory). Same inputs and outputs
    as the kernel: (forces (N, 3) in atom order, energy, virial (3, 3)),
    energy and virial None unless ``compute_energy``; ``lam_role`` is the
    (n_pad, 2) lambda_rows of the alchemical path. ``probe`` computes what
    that roofline probe computes (module docstring)."""
    _check_probe(probe)
    row, x, par, idc, bitc, chunks = _tiles(blockpairs, boundary, chunk)
    dtype, dev = x.dtype, x.device
    lrc = lam_role.view(-1, CLUSTER, 2) if spec.needs_lam else None
    forces = torch.zeros((n_atoms + 1, 3), dtype=dtype, device=dev)
    energy = torch.zeros((), dtype=dtype, device=dev)
    virial = torch.zeros((3, 3), dtype=dtype, device=dev)
    if probe in ("preponly", "gather_only"):
        chunks = []
    for I, J in chunks:
        dx, r2, live, special = _tile_geometry(
            spec, row, x[I], x[J], idc[I], idc[J], bitc[I], n_atoms)
        zero = torch.zeros_like(r2)
        if probe == "distance_only":
            e, coef = zero, torch.where(live, r2 * 1e-12, zero)
        else:
            pi, pj = par[I], par[J]
            args = (torch.where(live, r2, torch.ones_like(r2)),
                    0.5 * (pi[:, :, None, 0] + pj[:, None, :, 0]),
                    pi[:, :, None, 1] * pj[:, None, :, 1],
                    pi[:, :, None, 2] * pj[:, None, :, 2], special)
            if spec.needs_lam:
                li, lj = lrc[I], lrc[J]
                lam_s, lam_e = pair_lambdas(
                    spec, li[:, :, None, 0], lj[:, None, :, 0],
                    li[:, :, None, 1], lj[:, None, :, 1])
                e, coef = _pair_terms_alch(spec, *args, lam_s, lam_e)
            else:
                e, coef = _pair_terms(spec, *args)
            coef, e = torch.where(live, coef, zero), torch.where(live, e,
                                                                 zero)
        # the j side of cross tiles; noocc drops it
        cross = (I != J).to(dtype)[:, None, None] * (probe != "noocc")
        f_i = (coef[..., None] * dx).sum(dim=2)               # (T, 32, 3)
        f_j = -(coef[..., None] * dx * cross[..., None]).sum(dim=1)
        # in place: one (N + 1, 3) accumulator, row N takes the padding
        forces.index_add_(0, idc[I].reshape(-1), f_i.reshape(-1, 3))
        forces.index_add_(0, idc[J].reshape(-1), f_j.reshape(-1, 3))
        if compute_energy:
            # self tiles carry both orderings of each pair: weight 0.5
            w = torch.where(I == J, 0.5, 1.0).to(dtype)[:, None, None]
            energy = energy + (e * w).sum()
            cw = coef * w
            virial = virial - torch.einsum("tij,tija,tijb->ab", cw, dx, dx)
    if not compute_energy:
        return forces[:n_atoms], None, None
    return forces[:n_atoms], energy, virial


def live_pair_count(spec, blockpairs, boundary, n_atoms, lam_role=None,
                    chunk=1024):
    """(atom pairs the listed tiles evaluate inside cut_max, those of them
    that take the LJ term: eps != 0 inside the LJ radius, lambda_s > 0 on
    the soft-core path), each unordered pair once: the work the kernel's
    inputs need (for its bound)."""
    row, x, par, idc, bitc, chunks = _tiles(blockpairs, boundary, chunk)
    lrc = lam_role.view(-1, CLUSTER, 2) if spec.needs_lam else None
    pairs = lj_pairs = 0.0
    for I, J in chunks:
        _, r2, live, _ = _tile_geometry(spec, row, x[I], x[J], idc[I],
                                        idc[J], bitc[I], n_atoms)
        lj = live & (par[I][:, :, None, 1] * par[J][:, None, :, 1] != 0)
        lj &= bool(spec.lj_mode)
        if spec.lj_masked:
            lj &= r2 < spec.lj_rc ** 2
        if spec.lj_kind:
            li, lj_row = lrc[I], lrc[J]
            lj &= pair_lambdas(spec, li[:, :, None, 0], lj_row[:, None, :, 0],
                               li[:, :, None, 1], lj_row[:, None, :, 1])[0] > 0
        w = torch.where(I == J, 0.5, 1.0).to(torch.float64)
        pairs += float((live.sum(dim=(1, 2)).to(torch.float64) * w).sum())
        lj_pairs += float((lj.sum(dim=(1, 2)).to(torch.float64) * w).sum())
    return pairs, lj_pairs


def _check_cuda_input(name, t, dtype, width):
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if not t.is_contiguous() or t.shape[-1] != width:
        raise ValueError(f"{name} must be contiguous with last dim {width}")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} is not 16-byte aligned")


def _launch_spec(spec, blockpairs, boundary, n_atoms, compute_energy,
                 probe=""):
    inf = float("inf")
    lj_rc = spec.lj_rc if spec.lj_mode in (2, 3) else 1.0
    return _Launch(
        n_pairs=int(blockpairs.pairs.shape[0]), n_atoms=int(n_atoms),
        lj_mode=spec.lj_mode, coul_mode=spec.coul_mode,
        triclinic=int(getattr(boundary, "basis", None) is not None),
        compute_energy=int(bool(compute_energy)),
        cut2=spec.cut_max ** 2,
        lj_rc2=spec.lj_rc ** 2 if spec.lj_masked else inf,
        coul_rc2=spec.coul_rc ** 2 if spec.coul_masked else inf,
        lj_rc=lj_rc, inv_lj_rc=1.0 / lj_rc, inv_lj_rc2=1.0 / lj_rc ** 2,
        lj_w=spec.lj_w, coul_w=spec.coul_w, ke=spec.ke, alpha=spec.alpha,
        krf=spec.krf, crf=spec.crf, use_lam=int(spec.needs_lam),
        lj_kind=spec.lj_kind, coul_sc=spec.coul_sc,
        scheduler=(SCHEDULER_IDS[type(spec.scheduler)]
                   if spec.needs_lam else 0),
        lj_alpha=spec.lj_alpha, coul_alpha_sc=spec.coul_alpha_sc,
        coul_sigma_q=spec.coul_sigma_q, probe=KERNEL_PROBES.get(probe, 0))


def _order_after_last_launch(device, stream):
    """The launcher copies the box row into the kernel's one __constant__
    buffer on ``stream``; a kernel still queued on another stream reads
    that buffer, so ``stream`` first waits for the work queued there."""
    last = _LAST_STREAM.get(device)
    if last is not None and last != stream:
        stream.wait_stream(last)
    _LAST_STREAM[device] = stream


def launch_args(spec, blockpairs, boundary, n_atoms, lam_role, forces,
                energy_virial=None, probe=""):
    """Check the inputs and return the arguments of the C launcher
    ``pair_nonbonded_launch`` for a launch into the caller's zeroed
    ``forces`` (N, 3) f32 and, with energy, ``energy_virial`` (7,) f64, on
    the current stream, ordered after any launch queued on another one.
    The box reaches the kernel as ``boundary``'s minimum-image row in
    device memory (``mic_row_tensor``), the box of this call; the launch
    struct and the row ride as the last element (kept alive with them)."""
    _check_probe(probe)
    compute_energy = energy_virial is not None
    if probe in KERNEL_PROBES and (
            spec.coul_mode != 3 or compute_energy
            or getattr(boundary, "basis", None) is not None):
        raise ValueError(f"probe {probe!r} has kernel instances for "
                         "forces-only Ewald launches in an orthorhombic box "
                         "only")
    pos4, lj2, ids, bits, pairs = (blockpairs.pos4, blockpairs.lj2,
                                   blockpairs.ids, blockpairs.bits,
                                   blockpairs.pairs)
    _check_cuda_input("pos4", pos4, torch.float32, 4)
    _check_cuda_input("lj2", lj2, torch.float32, 2)
    _check_cuda_input("ids", ids.view(-1, 1), torch.int32, 1)
    _check_cuda_input("bits", bits, torch.int32, 4)
    mic_row = boundary.mic_row_tensor(torch.float32)
    _check_cuda_input("mic_row", mic_row, torch.float32, 9)
    if mic_row.device != pos4.device:
        raise ValueError("the box and the rows lie on different devices")
    if pairs.numel():
        _check_cuda_input("pairs", pairs, torch.int32, 2)
    lr_ptr = None
    if spec.needs_lam:
        _check_cuda_input("lam_role", lam_role, torch.float32, 2)
        if lam_role.shape[0] != pos4.shape[0]:
            raise ValueError("lam_role must have one row per slot")
        lr_ptr = lam_role.data_ptr()
    launch = _launch_spec(spec, blockpairs, boundary, n_atoms, compute_energy,
                          probe)
    stream = torch.cuda.current_stream(pos4.device)
    _order_after_last_launch(pos4.device, stream)
    return (pos4.data_ptr(), lj2.data_ptr(), ids.data_ptr(), bits.data_ptr(),
            pairs.data_ptr(), lr_ptr, mic_row.data_ptr(),
            ctypes.addressof(launch), forces.data_ptr(),
            energy_virial.data_ptr() if compute_energy else None,
            stream.cuda_stream, (launch, mic_row))


def _pair_nonbonded_cuda(spec, blockpairs, boundary, n_atoms,
                         compute_energy=False, lam_role=None, probe=""):
    """Launch csrc/pair_nonbonded.cu on the current stream of the card the
    tensors lie on (f32 only). A forces-only call issues one fill of the
    force buffer and the launch; energy and virial are then None.
    ``probe`` "preponly" launches nothing (zeros out)."""
    dev = blockpairs.pos4.device
    forces = torch.zeros((n_atoms, 3), dtype=torch.float32, device=dev)
    ev = (torch.zeros((7,), dtype=torch.float64, device=dev)
          if compute_energy else None)
    args = launch_args(spec, blockpairs, boundary, n_atoms, lam_role, forces,
                       ev, probe)
    if probe != "preponly":
        # the stream launch_args ordered is the current one native.launch
        # appends
        native.launch("pair_nonbonded", "pair_nonbonded_launch", _SIG,
                      *args[:-2], device=dev)
        family = instance_family(spec, boundary) + (
            f"+{probe}" if probe in KERNEL_PROBES else "")
        INSTANCE_LAUNCHES[family] += 1
        ENERGY_LAUNCHES[family] += int(compute_energy)
    if not compute_energy:
        return forces, None, None
    energy = ev[0].to(torch.float32)
    v = ev[1:].to(torch.float32)
    virial = torch.stack([v[0], v[1], v[2], v[1], v[3], v[4], v[2], v[4],
                          v[5]]).view(3, 3)
    return forces, energy, virial


def refuse_grad(*tensors):
    """The pair kernel has no backward (nor has the JAX package's): raise
    NotImplementedError when grad mode is on and one of ``tensors``
    requires grad, on either device, so that a gradient through the
    cluster-pair path fails instead of coming back detached."""
    if tracks_grad(*tensors):
        raise NotImplementedError(
            "the pair kernel (the cluster-pair list of BlockPairFinder) has "
            "no backward: differentiate through the dense engine "
            "(use_neighbors=False) or the neighbor-table engine "
            "(neighbor_finder=\"cell\" or \"distance\")")


def pair_nonbonded(spec, blockpairs, boundary, n_atoms, compute_energy=False,
                   lam_role=None, probe=""):
    """(forces (N, 3), energy, virial (3, 3)) of every listed pair inside
    cut_max; energy and virial are None unless ``compute_energy``. CPU
    tensors run the plain twin; CUDA tensors launch the kernel (f32 only)
    or raise. ``probe`` names a roofline probe (never on a main path).
    Raises NotImplementedError for inputs that require grad
    (``refuse_grad``)."""
    refuse_grad(blockpairs.pos4, blockpairs.lj2, lam_role)
    if blockpairs.pos4.is_cuda:
        return _pair_nonbonded_cuda(spec, blockpairs, boundary, n_atoms,
                                    compute_energy, lam_role, probe)
    if blockpairs.pos4.device.type != "cpu":
        raise ValueError(f"unsupported device {blockpairs.pos4.device}")
    return pair_nonbonded_plain(spec, blockpairs, boundary, n_atoms,
                                compute_energy, lam_role, probe=probe)


def far_pair_corrections(spec, coords, boundary, atoms, exclusions, forces,
                         energy, virial, charge=None):
    """Fix the kernel's treatment of exclusion / 1-4 pairs whose id span
    exceeds the bitmap window (|j - i| > 31): the kernel computed them at
    full strength, so excluded pairs are subtracted and 1-4 pairs get
    (scaled - full) added. ``charge`` is the charge the kernel saw (the
    scaled one under scale_q); the alchemical path resolves each pair's
    lambdas as the kernel does (pallas_pairwise.py:580-603). Energy and
    virial None (a forces-only call) stay None."""
    far_e, far_s = exclusions.far_excl, exclusions.far_spec
    if far_e.shape[0] == 0 and far_s.shape[0] == 0:
        return forces, energy, virial
    dtype = coords.dtype
    charge = atoms.charge if charge is None else charge
    par = torch.stack([atoms.sigma, torch.sqrt(atoms.epsilon), charge],
                      dim=1).to(dtype)
    if spec.needs_lam:
        lr = _atom_lambda_rows(atoms, dtype)

    def apply(pairs, special, forces, energy, virial):
        if pairs.shape[0] == 0:
            return forces, energy, virial
        i, j = pairs[:, 0].long(), pairs[:, 1].long()
        dx = boundary.displacement(coords[i], coords[j])        # x_j - x_i
        r2 = (dx * dx).sum(dim=1)
        inside = r2 < spec.cut_max ** 2
        r2s = torch.where(inside, r2, torch.ones_like(r2))
        args = (r2s, 0.5 * (par[i, 0] + par[j, 0]), par[i, 1] * par[j, 1],
                par[i, 2] * par[j, 2])
        if spec.needs_lam:
            lams = pair_lambdas(spec, lr[i, 0], lr[j, 0], lr[i, 1],
                                lr[j, 1])

            def terms(sp):
                return _pair_terms_alch(spec, *args, sp, *lams)
        else:
            def terms(sp):
                return _pair_terms(spec, *args, sp)
        e_full, c_full = terms(torch.zeros_like(inside))
        if special:
            e_sp, c_sp = terms(torch.ones_like(inside))
            de, dc = e_sp - e_full, c_sp - c_full
        else:
            de, dc = -e_full, -c_full
        zero = torch.zeros_like(r2s)
        de, dc = torch.where(inside, de, zero), torch.where(inside, dc, zero)
        fvec = (dc[:, None] * dx).to(forces.dtype)
        forces = forces.index_add(0, i, fvec).index_add(0, j, -fvec)
        if energy is not None:
            energy = energy + de.sum().to(energy.dtype)
            virial = virial - torch.einsum("k,ka,kb->ab", dc, dx, dx).to(
                virial.dtype)
        return forces, energy, virial

    forces, energy, virial = apply(far_e, False, forces, energy, virial)
    return apply(far_s, True, forces, energy, virial)


def kernel_inputs(spec, coords, atoms, blockpairs, probe=""):
    """The list's slot rows for one call: (blockpairs with this call's
    coordinates, the (n_pad, 2) lambda rows or None, the charge the kernel
    sees in atom order or None for the atoms' own). The roofline probe
    "nogather" leaves the rows' coordinates as they were (the rebuild's);
    other probes act later, in pair_nonbonded.

    Lambda may change between calls on one list (the cross energies of
    several windows), so nothing lambda-dependent is packed at rebuild: the
    alchemical path gathers its (lambda, role) rows per call, and the
    scaled-charge family fills a fresh slot buffer with the scaled charges,
    leaving the rebuild-time charge column as it was."""
    _check_probe(probe)
    # in place: the rebuild-time row buffer takes this step's coordinates,
    # so the only per-step data movement of the plain path is this gather
    if probe != "nogather":
        blockpairs.pos4[:, :3] = coords[blockpairs.src]
    charge = None
    if spec.scale_q:
        charge = scaled_charge(spec.scheduler, atoms.charge, atoms.lam,
                               atoms.alch_role)
        q = torch.where(blockpairs.ids < coords.shape[0],
                        charge.to(coords.dtype)[blockpairs.src], 0.0)
        blockpairs = dataclasses.replace(
            blockpairs, pos4=torch.cat([blockpairs.pos4[:, :3], q[:, None]],
                                       dim=1))
    lam_role = lambda_rows(atoms, blockpairs) if spec.needs_lam else None
    return blockpairs, lam_role, charge


def block_nonbonded(spec, coords, boundary, atoms, exclusions, blockpairs,
                    compute_energy=False):
    """Main-path entry (counterpart of pallas_block_nonbonded): fill this
    call's slot rows (kernel_inputs), run the pair kernel (or its twin on
    CPU) and apply the far-pair corrections. It takes no roofline probe.
    Energy and virial are None unless ``compute_energy``. Raises
    NotImplementedError for inputs that require grad (``refuse_grad``)."""
    refuse_grad(coords, *atom_tensors(atoms),
                getattr(boundary, "side_lengths", None),
                getattr(boundary, "basis", None))
    blockpairs, lam_role, charge = kernel_inputs(spec, coords, atoms,
                                                 blockpairs)
    forces, energy, virial = pair_nonbonded(spec, blockpairs, boundary,
                                            coords.shape[0], compute_energy,
                                            lam_role)
    forces = forces.to(coords.dtype)
    if compute_energy:
        energy, virial = energy.to(coords.dtype), virial.to(coords.dtype)
    return far_pair_corrections(spec, coords, boundary, atoms, exclusions,
                                forces, energy, virial, charge)
