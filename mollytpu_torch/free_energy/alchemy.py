"""Alchemical lambda schedulers (counterpart of
mollytpu/free_energy/alchemy.py:18-114).

Per-atom (lambda, role) state maps to sterics / electrostatics scales
through a scheduler. Schedulers are stateless tags whose piecewise
schedules are torch.where on tensors. The pair kernel evaluates the same
schedules per pair (csrc/pair_nonbonded.cu, ``scale_sterics`` /
``scale_elec``), selected by ``SCHEDULER_IDS``.

Roles: CORE = 0, INSERT = 1, DELETE = 2 (atoms.ALCH_*).
"""

from __future__ import annotations

import torch

from ..atoms import ALCH_CORE, ALCH_DELETE, ALCH_INSERT


def mix_roles(role_i, role_j):
    """Pair role: INSERT dominates, then DELETE, else CORE."""
    either_insert = (role_i == ALCH_INSERT) | (role_j == ALCH_INSERT)
    either_delete = (role_i == ALCH_DELETE) | (role_j == ALCH_DELETE)
    return torch.where(either_insert, ALCH_INSERT,
                       torch.where(either_delete, ALCH_DELETE, ALCH_CORE))


def _piecewise(lam, role, insert_fn, delete_fn):
    return torch.where(role == ALCH_INSERT, insert_fn(lam),
                       torch.where(role == ALCH_DELETE, delete_fn(lam), lam))


class DefaultLambdaScheduler:
    """Inserted atoms: sterics over the first half of lambda, electrostatics
    over the second; deleted atoms the other way round."""

    @staticmethod
    def scale_sterics(lam, role):
        return _piecewise(
            lam, role,
            lambda l: torch.where(l < 0.5, 2.0 * l, 1.0),
            lambda l: torch.where(l < 0.5, 0.0, 2.0 * (l - 0.5)))

    @staticmethod
    def scale_elec(lam, role):
        return _piecewise(
            lam, role,
            lambda l: torch.where(l < 0.5, 0.0, 2.0 * (l - 0.5)),
            lambda l: torch.where(l < 0.5, 2.0 * l, 1.0))


class NAMDLambdaScheduler:
    @staticmethod
    def scale_sterics(lam, role):
        return _piecewise(
            lam, role,
            lambda l: torch.where(l < 2.0 / 3.0, 1.5 * l, 1.0),
            lambda l: torch.where(l < 1.0 / 3.0, 0.0, (l - 1.0 / 3.0) * 1.5))

    # staticmethod again: the attribute read off the class is a plain
    # function, which an instance would otherwise bind as a method
    scale_elec = staticmethod(DefaultLambdaScheduler.scale_elec)


class QuartersLambdaScheduler:
    @staticmethod
    def scale_sterics(lam, role):
        return _piecewise(
            lam, role,
            lambda l: torch.where(l < 0.5, 0.0, torch.where(
                l > 0.75, 1.0, 4.0 * (l - 0.5))),
            lambda l: torch.where(l < 0.25, 0.0, torch.where(
                l > 0.5, 1.0, 4.0 * (l - 0.25))))

    @staticmethod
    def scale_elec(lam, role):
        return _piecewise(
            lam, role,
            lambda l: torch.where(l < 0.75, 0.0, 4.0 * (l - 0.75)),
            lambda l: torch.where(l < 0.25, 4.0 * l, 1.0))


class EleScaledLambdaScheduler:
    scale_sterics = staticmethod(DefaultLambdaScheduler.scale_sterics)

    @staticmethod
    def scale_elec(lam, role):
        return _piecewise(
            lam, role,
            lambda l: torch.where(l < 0.5, 0.0, torch.sqrt(
                torch.clamp(2.0 * (l - 0.5), min=0.0))),
            lambda l: torch.where(l < 0.5, (2.0 * l) ** 2, 1.0))


#: the pair kernel's runtime scheduler switch
SCHEDULER_IDS = {DefaultLambdaScheduler: 0, NAMDLambdaScheduler: 1,
                 QuartersLambdaScheduler: 2, EleScaledLambdaScheduler: 3}


def sterics_lambda(scheduler, lam_mixed, role_i, role_j):
    """Pairwise sterics scale; the same non-core role on both atoms is fully
    on (interactions inside a perturbed group are never softened)."""
    same_noncore = (role_i == role_j) & (role_i != ALCH_CORE)
    pair_role = mix_roles(role_i, role_j)
    return torch.where(same_noncore, 1.0,
                       scheduler.scale_sterics(lam_mixed, pair_role))


def elec_lambda(scheduler, lam_mixed, role_i, role_j):
    same_noncore = (role_i == role_j) & (role_i != ALCH_CORE)
    pair_role = mix_roles(role_i, role_j)
    return torch.where(same_noncore, 1.0,
                       scheduler.scale_elec(lam_mixed, pair_role))


def scaled_charge(scheduler, charge, lam, role):
    """Per-atom effective charge q * scale_elec(lambda, role)."""
    return charge * scheduler.scale_elec(lam, role)
