"""Minimal PDB reader (host-side setup code, carried over unchanged from
mollytpu/models/pdb.py).

Replaces Molly.jl's Chemfiles dependency for the setup path
(src/setup.jl:430-520): parses ATOM/HETATM/CRYST1/CONECT/TER records into
plain numpy structures in internal units (nm).
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple

import numpy as np

_ELEMENT_MASSES = {
    "H": 1.008, "C": 12.011, "N": 14.007, "O": 15.999, "S": 32.06,
    "P": 30.974, "NA": 22.99, "CL": 35.45, "K": 39.098, "MG": 24.305,
    "CA": 40.078, "ZN": 65.38, "FE": 55.845, "BR": 79.904, "I": 126.9,
    "F": 18.998,
}


@dataclasses.dataclass
class PDBResidue:
    name: str
    number: int
    chain: str
    insertion: str
    atom_names: List[str]
    atom_indices: List[int]
    hetero: bool


@dataclasses.dataclass
class PDBStructure:
    coords: np.ndarray            # (N, 3) nm
    atom_names: List[str]
    elements: List[str]
    residues: List[PDBResidue]
    res_index_of_atom: np.ndarray  # (N,)
    box: Optional[np.ndarray]      # (3,) nm orthorhombic or (3,3) triclinic
    conect: List[Tuple[int, int]]

    @property
    def n_atoms(self):
        return self.coords.shape[0]


def _element_from_columns(line, name):
    el = line[76:78].strip() if len(line) >= 78 else ""
    if el:
        return el.capitalize() if len(el) > 1 else el.upper()
    # fall back to the atom name: first alphabetic character, handling
    # leading digits (e.g. 1HB2)
    for ch in name:
        if ch.isalpha():
            return ch.upper()
    return "?"


def read_pdb(path):
    coords = []
    atom_names: List[str] = []
    elements: List[str] = []
    residues: List[PDBResidue] = []
    res_of_atom: List[int] = []
    box = None
    conect: List[Tuple[int, int]] = []
    serial_to_index = {}
    cur_key = None
    for line in open(path):
        rec = line[:6]
        if rec in ("ATOM  ", "HETATM"):
            serial = line[6:11].strip()
            name = line[12:16].strip()
            altloc = line[16]
            if altloc not in (" ", "A"):
                continue
            resname = line[17:21].strip()
            chain = line[21]
            resnum = int(line[22:26])
            icode = line[26]
            x = float(line[30:38]) * 0.1
            y = float(line[38:46]) * 0.1
            z = float(line[46:54]) * 0.1
            idx = len(coords)
            serial_to_index[serial] = idx
            key = (chain, resnum, icode, resname)
            if key != cur_key:
                residues.append(PDBResidue(resname, resnum, chain, icode, [], [],
                                           rec == "HETATM"))
                cur_key = key
            residues[-1].atom_names.append(name)
            residues[-1].atom_indices.append(idx)
            res_of_atom.append(len(residues) - 1)
            coords.append((x, y, z))
            atom_names.append(name)
            elements.append(_element_from_columns(line, name))
        elif rec == "CRYST1":
            a = float(line[6:15]) * 0.1
            b = float(line[15:24]) * 0.1
            c = float(line[24:33]) * 0.1
            al = math.radians(float(line[33:40]))
            be = math.radians(float(line[40:47]))
            ga = math.radians(float(line[47:54]))
            if (abs(al - math.pi / 2) < 1e-6 and abs(be - math.pi / 2) < 1e-6
                    and abs(ga - math.pi / 2) < 1e-6):
                box = np.array([a, b, c])
            else:
                v1 = np.array([a, 0.0, 0.0])
                v2 = np.array([b * math.cos(ga), b * math.sin(ga), 0.0])
                cx = c * math.cos(be)
                cy = c * (math.cos(al) - math.cos(be) * math.cos(ga)) / math.sin(ga)
                cz = math.sqrt(max(c * c - cx * cx - cy * cy, 0.0))
                box = np.stack([v1, v2, np.array([cx, cy, cz])])
        elif rec == "CONECT":
            fields = [line[i:i + 5].strip() for i in range(6, 31, 5)]
            fields = [f for f in fields if f]
            if fields and fields[0] in serial_to_index:
                a0 = serial_to_index[fields[0]]
                for f in fields[1:]:
                    if f in serial_to_index:
                        b0 = serial_to_index[f]
                        if a0 != b0:
                            conect.append((min(a0, b0), max(a0, b0)))
        elif rec == "ENDMDL":
            break  # first model only
    return PDBStructure(
        coords=np.asarray(coords, dtype=np.float64),
        atom_names=atom_names, elements=elements, residues=residues,
        res_index_of_atom=np.asarray(res_of_atom, dtype=np.int64),
        box=box, conect=sorted(set(conect)))


def element_mass(element):
    return _ELEMENT_MASSES.get(element.upper(), 0.0)
