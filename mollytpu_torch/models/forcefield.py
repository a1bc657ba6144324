"""OpenMM-format force-field XML ingestion (carried over unchanged from
mollytpu/models/forcefield.py; plain Python, no tensors).

Host-side, pure-Python re-design of Molly.jl's MolecularForceField
(src/force_field.jl:297-1167): parses AtomTypes, Residues
(+patches, virtual sites), HarmonicBondForce, HarmonicAngleForce (+ Urey-
Bradley via CHARMM's amber-style entries), PeriodicTorsionForce (proper /
improper with wildcard matching, specificity scoring and OpenMM ordering
semantics), RBTorsionForce, CMAPTorsionForce, NonbondedForce
(UseAttributeFromResidue, 1-4 scales), LennardJonesForce (NBFix) and
<Include> files.

Matching semantics follow OpenMM (and the reference's resolvers,
force_field.jl:81-295): a pattern position matches by type name, class name,
or wildcard ""; an exact (wildcard-free) match wins immediately, otherwise
the most specific wildcard match (type=2 > class=1 > wild=0 per position)
is used. Proper torsions try forward and reversed; impropers scan the six
permutations of the peripheral atoms with the central atom first.
"""

from __future__ import annotations

import dataclasses
import math
import os
import xml.etree.ElementTree as ET
from typing import Dict, List, Optional, Tuple

KCAL_TO_KJ = 4.184

WILD, CLASS, TYPE = 0, 1, 2


@dataclasses.dataclass
class AtomPattern:
    kind: int  # WILD | CLASS | TYPE
    value: str = ""

    def matches(self, type_name, type_to_class):
        if self.kind == WILD:
            return True
        if self.kind == TYPE:
            return type_name == self.value
        return type_to_class.get(type_name) == self.value


def _pattern(attrib, i):
    """Pattern from typeN= / classN= attributes (empty string = wildcard)."""
    t = attrib.get(f"type{i}")
    if t is not None:
        return AtomPattern(TYPE, t) if t != "" else AtomPattern(WILD)
    c = attrib.get(f"class{i}")
    if c is not None:
        return AtomPattern(CLASS, c) if c != "" else AtomPattern(WILD)
    return AtomPattern(WILD)


def _specificity(patterns):
    return sum(p.kind for p in patterns)


def _has_wild(patterns):
    return any(p.kind == WILD for p in patterns)


@dataclasses.dataclass
class AtomType:
    name: str
    clazz: str
    element: str
    mass: float


@dataclasses.dataclass
class TemplateAtom:
    name: str
    type: str
    charge: Optional[float] = None


@dataclasses.dataclass
class TemplateVirtualSite:
    site_type: str                # "average2" | "average3" | "outOfPlane"
    index: int                    # site atom index within the template
    atoms: Tuple[int, ...]        # parent atom indices within the template
    weights: Tuple[float, ...]    # wt (average) or (w12, w13, wcross)


@dataclasses.dataclass
class ResidueTemplate:
    name: str
    atoms: List[TemplateAtom]
    bonds: List[Tuple[int, int]]
    external: List[int]
    virtual_sites: List[TemplateVirtualSite] = dataclasses.field(default_factory=list)
    override: str = ""
    allowed_patches: List[str] = dataclasses.field(default_factory=list)

    @property
    def atom_names(self):
        return frozenset(a.name for a in self.atoms)


@dataclasses.dataclass
class ResiduePatchTemplate:
    """A CHARMM-style residue patch (<Patches>/<Patch>), reference:
    force_field.jl:478-521 + residues.jl ResiduePatchTemplate:18."""

    name: str
    add_atoms: List[Tuple[str, str, Optional[float]]]     # name, type, charge
    change_atoms: List[Tuple[str, str, Optional[float]]]
    remove_atoms: List[str]
    add_bonds: List[Tuple[str, str]]
    remove_bonds: List[Tuple[str, str]]
    add_external_bonds: List[str]
    remove_external_bonds: List[str]
    apply_to_residues: List[str]


def _apply_residue_patch(residue, patch, patched_name, strictness=None):
    """Apply a ResiduePatchTemplate to a ResidueTemplate, returning the
    patched template or None if the patch does not fit (reference:
    residues.jl apply_residue_patch:739-877; invalid patches report + skip
    per the strictness level)."""
    from ..config import report_issue

    def _warn(msg):
        report_issue(f"can't apply patch {patch.name} to residue template "
                     f"{residue.name}: {msg}", strictness)

    atoms = list(residue.atoms)
    bonds = list(residue.bonds)
    external = list(residue.external)
    vsites = list(residue.virtual_sites)

    def _idx(name):
        for i, a in enumerate(atoms):
            if a.name == name:
                return i
        return None

    for name, atype, charge in patch.add_atoms:
        if _idx(name) is not None:
            _warn(f"atom name {name} already present")
            return None
        atoms.append(TemplateAtom(name, atype, charge))
    for name, atype, charge in patch.change_atoms:
        i = _idx(name)
        if i is None:
            _warn(f"atom name {name} missing")
            return None
        atoms[i] = TemplateAtom(name, atype, charge)
    # remove bonds before atoms: a bond endpoint may be removed next
    for n1, n2 in patch.remove_bonds:
        i, j = _idx(n1), _idx(n2)
        if i is None or j is None:
            _warn(f"atom name {n1 if i is None else n2} missing")
            return None
        key = {i, j}
        hit = next((bi for bi, b in enumerate(bonds) if set(b) == key), None)
        if hit is None:
            _warn(f"bond between {n1} and {n2} missing")
            return None
        del bonds[hit]
    for name in patch.remove_atoms:
        i = _idx(name)
        if i is None:
            _warn(f"atom name {name} missing")
            return None
        if any(i in b for b in bonds):
            _warn(f"atom name {name} can't be removed as it is part of a "
                  "bond")
        if any(i == v.index or i in v.atoms for v in vsites):
            _warn(f"atom name {name} is part of a virtual site")
            return None
        del atoms[i]
        external = [e - (e > i) for e in external if e != i]
        bonds = [(a - (a > i), b - (b > i)) for a, b in bonds
                 if a != i and b != i]
        vsites = [dataclasses.replace(
            v, index=v.index - (v.index > i),
            atoms=tuple(a - (a > i) for a in v.atoms)) for v in vsites]
    for n1, n2 in patch.add_bonds:
        i, j = _idx(n1), _idx(n2)
        if i is None or j is None:
            _warn(f"atom name {n1 if i is None else n2} missing")
            return None
        if any(set(b) == {i, j} for b in bonds):
            _warn(f"bond between {n1} and {n2} already present")
            return None
        bonds.append((i, j))
    for name in patch.add_external_bonds:
        i = _idx(name)
        if i is None:
            _warn(f"atom name {name} missing")
            return None
        external.append(i)
    for name in patch.remove_external_bonds:
        i = _idx(name)
        if i is None:
            _warn(f"atom name {name} missing")
            return None
        if i in external:
            external.remove(i)
    return ResidueTemplate(patched_name, atoms, bonds, external, vsites,
                           override=residue.override, allowed_patches=[])


@dataclasses.dataclass
class BondRule:
    p1: AtomPattern
    p2: AtomPattern
    length: float
    k: float


@dataclasses.dataclass
class AngleRule:
    p1: AtomPattern
    p2: AtomPattern
    p3: AtomPattern
    theta0: float
    k: float
    # CHARMM-style Urey-Bradley 1-3 term attached to the angle definition
    ub_k: float = 0.0
    ub_d: float = 0.0


@dataclasses.dataclass
class TorsionRule:
    patterns: Tuple[AtomPattern, ...]
    proper: bool
    terms: List[Tuple[float, float, float]]  # (periodicity, phase, k)
    ordering: str = "default"

    def __post_init__(self):
        self.has_wild = _has_wild(self.patterns)
        self.specificity = _specificity(self.patterns)


@dataclasses.dataclass
class RBTorsionRule:
    patterns: Tuple[AtomPattern, ...]
    proper: bool
    coeffs: Tuple[float, ...]

    def __post_init__(self):
        self.has_wild = _has_wild(self.patterns)
        self.specificity = _specificity(self.patterns)


@dataclasses.dataclass
class CMAPRule:
    patterns: Tuple[AtomPattern, ...]  # 5 patterns
    map_index: int

    def __post_init__(self):
        self.has_wild = _has_wild(self.patterns)
        self.specificity = _specificity(self.patterns)


@dataclasses.dataclass
class NonbondedEntry:
    pattern: AtomPattern
    sigma: float
    epsilon: float
    charge: Optional[float] = None


class ForceField:
    """Parsed force field. Construct with one or more XML paths (later files
    override/extend earlier ones, as in OpenMM)."""

    #: top-level XML tags the parser understands; anything else is reported
    #: through the strictness system (reference: force_field.jl:808-811)
    KNOWN_TAGS = frozenset({
        "Info", "Include", "AtomTypes", "Residues", "Patches",
        "HarmonicBondForce", "HarmonicAngleForce", "PeriodicTorsionForce",
        "RBTorsionForce", "CMAPTorsionForce", "NonbondedForce",
        "LennardJonesForce", "Script",
    })

    def __init__(self, *paths, strictness=None):
        self.strictness = strictness
        self.atom_types: Dict[str, AtomType] = {}
        self.residues: Dict[str, ResidueTemplate] = {}
        self.patches: Dict[str, ResiduePatchTemplate] = {}
        self.bond_rules: List[BondRule] = []
        self.angle_rules: List[AngleRule] = []
        self.torsion_rules: List[TorsionRule] = []
        self.rb_rules: List[RBTorsionRule] = []
        self.cmap_rules: List[CMAPRule] = []
        self.cmap_maps: List = []  # each: 2D list of energies (kJ/mol)
        self.nonbonded: List[NonbondedEntry] = []
        self.lj_entries: List[NonbondedEntry] = []  # separate LennardJonesForce
        self.nbfix: List[Tuple[str, str, float, float]] = []  # class1, class2, sigma, eps
        self.coulomb14scale = 1.0 / 1.2
        self.lj14scale = 0.5
        self.charge_from_residue = False
        self._content_hash = None   # sha256 over loaded XML bytes (cache key)
        for p in paths:
            self.load(p)
        self._apply_patches()
        self._index()

    @property
    def fingerprint(self):
        h = getattr(self, "_content_hash", None)
        return h.hexdigest() if h is not None else ""

    # -- parsing -------------------------------------------------------------

    def load(self, path):
        import hashlib
        if getattr(self, "_content_hash", None) is None:
            self._content_hash = hashlib.sha256()
        with open(path, "rb") as fh:
            self._content_hash.update(fh.read())
        tree = ET.parse(path)
        root = tree.getroot()
        from ..config import report_issue
        for child in root:
            if child.tag not in self.KNOWN_TAGS:
                report_issue(f"ignoring unknown force-field XML entry "
                             f"{child.tag} in {os.path.basename(path)}",
                             self.strictness)
        for inc in root.findall("Include"):
            self.load(os.path.join(os.path.dirname(path), inc.attrib["file"]))
        for node in root.findall("AtomTypes/Type"):
            a = node.attrib
            self.atom_types[a["name"]] = AtomType(
                a["name"], a.get("class", a["name"]), a.get("element", "?"),
                float(a.get("mass", 0.0)))
        for rnode in root.findall("Residues/Residue"):
            self._parse_residue(rnode)
        for pnode in root.findall("Patches/Patch"):
            self._parse_patch(pnode)
        for node in root.findall("HarmonicBondForce/Bond"):
            a = node.attrib
            self.bond_rules.append(BondRule(
                _pattern(a, 1), _pattern(a, 2),
                float(a["length"]), float(a["k"])))
        for node in root.findall("HarmonicAngleForce/Angle"):
            a = node.attrib
            self.angle_rules.append(AngleRule(
                _pattern(a, 1), _pattern(a, 2), _pattern(a, 3),
                float(a["angle"]), float(a["k"]),
                ub_k=float(a.get("kub", 0.0)), ub_d=float(a.get("d", 0.0))))
        # CHARMM urey-bradley as separate force (OpenMM uses AmberUreyBradley
        # entries inside HarmonicAngleForce via kub/d attributes; handled above)
        for ptf in root.findall("PeriodicTorsionForce"):
            ordering = ptf.attrib.get("ordering", "default")
            for tag, proper in (("Proper", True), ("Improper", False)):
                for node in ptf.findall(tag):
                    a = node.attrib
                    pats = tuple(_pattern(a, i) for i in range(1, 5))
                    terms = []
                    i = 1
                    while f"periodicity{i}" in a:
                        terms.append((float(a[f"periodicity{i}"]),
                                      float(a[f"phase{i}"]), float(a[f"k{i}"])))
                        i += 1
                    self.torsion_rules.append(TorsionRule(pats, proper, terms, ordering))
        for tag, proper in (("Proper", True), ("Improper", False)):
            for node in root.findall(f"RBTorsionForce/{tag}"):
                a = node.attrib
                pats = tuple(_pattern(a, i) for i in range(1, 5))
                coeffs = tuple(float(a.get(f"c{i}", 0.0)) for i in range(6))
                self.rb_rules.append(RBTorsionRule(pats, proper, coeffs))
        for cnode in root.findall("CMAPTorsionForce"):
            base = len(self.cmap_maps)
            for mnode in cnode.findall("Map"):
                vals = [float(x) for x in mnode.text.split()]
                self.cmap_maps.append(vals)
            for tnode in cnode.findall("Torsion"):
                a = tnode.attrib
                pats = tuple(_pattern(a, i) for i in range(1, 6))
                self.cmap_rules.append(CMAPRule(pats, base + int(a["map"])))
        for nb in root.findall("NonbondedForce"):
            self.coulomb14scale = float(nb.attrib.get("coulomb14scale",
                                                      self.coulomb14scale))
            self.lj14scale = float(nb.attrib.get("lj14scale", self.lj14scale))
            for u in nb.findall("UseAttributeFromResidue"):
                if u.attrib.get("name") == "charge":
                    self.charge_from_residue = True
            for node in nb.findall("Atom"):
                a = node.attrib
                self.nonbonded.append(NonbondedEntry(
                    _pattern(a, ""), float(a.get("sigma", 0.0)),
                    float(a.get("epsilon", 0.0)),
                    float(a["charge"]) if "charge" in a else None))
        for ljf in root.findall("LennardJonesForce"):
            # a separate LennardJonesForce supersedes the NonbondedForce
            # sigma/epsilon (which then carries only charges), as in OpenMM
            self.lj14scale = float(ljf.attrib.get("lj14scale", self.lj14scale))
            for node in ljf.findall("Atom"):
                a = node.attrib
                self.lj_entries.append(NonbondedEntry(
                    _pattern(a, ""), float(a.get("sigma", 0.0)),
                    float(a.get("epsilon", 0.0)), None))
            for node in ljf.findall("NBFixPair"):
                a = node.attrib
                self.nbfix.append((a.get("class1", a.get("type1")),
                                   a.get("class2", a.get("type2")),
                                   float(a["sigma"]), float(a["epsilon"])))

    def _parse_residue(self, rnode):
        name = rnode.attrib["name"]
        atoms, bonds, external, vsites = [], [], [], []
        name_to_idx = {}
        for anode in rnode.findall("Atom"):
            a = anode.attrib
            name_to_idx[a["name"]] = len(atoms)
            atoms.append(TemplateAtom(
                a["name"], a["type"],
                float(a["charge"]) if "charge" in a else None))
        for bnode in rnode.findall("Bond"):
            a = bnode.attrib
            if "atomName1" in a:
                bonds.append((name_to_idx[a["atomName1"]], name_to_idx[a["atomName2"]]))
            else:
                bonds.append((int(a["from"]), int(a["to"])))
        for enode in rnode.findall("ExternalBond"):
            a = enode.attrib
            if "atomName" in a:
                external.append(name_to_idx[a["atomName"]])
            else:
                external.append(int(a["from"]))
        for vnode in rnode.findall("VirtualSite"):
            a = vnode.attrib
            stype = a["type"]
            if "siteName" in a:
                sidx = name_to_idx[a["siteName"]]
                parents = []
                i = 1
                while f"atomName{i}" in a:
                    parents.append(name_to_idx[a[f"atomName{i}"]])
                    i += 1
            else:
                sidx = int(a["index"])
                parents = []
                i = 1
                while f"atom{i}" in a:
                    parents.append(int(a[f"atom{i}"]))
                    i += 1
            if stype == "average2":
                weights = (float(a["weight1"]), float(a["weight2"]))
            elif stype == "average3":
                weights = (float(a["weight1"]), float(a["weight2"]),
                           float(a["weight3"]))
            elif stype == "outOfPlane":
                weights = (float(a["weight12"]), float(a["weight13"]),
                           float(a["weightCross"]))
            elif stype == "localCoords":
                # store raw params; sites.py interprets
                weights = tuple(float(a[k]) for k in sorted(a)
                                if k.startswith(("p", "wo", "wx", "wy")))
            else:
                # reference: "not currently supported, ignoring"
                # (force_field.jl:808) — report per strictness and skip
                from ..config import report_issue
                report_issue(f"unsupported virtual site type {stype}; "
                             "ignoring site", self.strictness)
                continue
            vsites.append(TemplateVirtualSite(stype, sidx, tuple(parents), weights))
        allowed = [p.attrib["name"] for p in rnode.findall("AllowPatch")]
        self.residues[name] = ResidueTemplate(
            name, atoms, bonds, external, vsites,
            override=rnode.attrib.get("override", ""),
            allowed_patches=allowed)

    def _parse_patch(self, pnode):
        """<Patch> parsing (reference: force_field.jl:478-521). Multi-residue
        patches (residues != 1) are reported per strictness and skipped."""
        from ..config import report_issue
        a = pnode.attrib
        pname = a["name"]
        if a.get("residues", "1") != "1":
            report_issue(f"residue patch {pname} alters multiple templates; "
                         "not supported, ignoring", self.strictness)
            return
        patch = ResiduePatchTemplate(pname, [], [], [], [], [], [], [], [])
        for el in pnode:
            e = el.attrib
            if el.tag == "AddAtom":
                patch.add_atoms.append((
                    e["name"], e["type"],
                    float(e["charge"]) if "charge" in e else None))
            elif el.tag == "ChangeAtom":
                patch.change_atoms.append((
                    e["name"], e["type"],
                    float(e["charge"]) if "charge" in e else None))
            elif el.tag == "RemoveAtom":
                patch.remove_atoms.append(e["name"])
            elif el.tag == "AddBond":
                patch.add_bonds.append((e["atomName1"], e["atomName2"]))
            elif el.tag == "RemoveBond":
                patch.remove_bonds.append((e["atomName1"], e["atomName2"]))
            elif el.tag == "AddExternalBond":
                patch.add_external_bonds.append(e["atomName"])
            elif el.tag == "RemoveExternalBond":
                patch.remove_external_bonds.append(e["atomName"])
            elif el.tag == "ApplyToResidue":
                patch.apply_to_residues.append(e["name"])
        self.patches[pname] = patch

    def _apply_patches(self):
        """Generate patched residue variants "<res>_<patch>" for every
        allowed (residue, patch) pair; they then compete in ordinary template
        matching (reference: force_field.jl:924-957)."""
        if not self.patches:
            return
        for res_name in list(self.residues):
            to_apply = list(self.residues[res_name].allowed_patches)
            for pname, patch in self.patches.items():
                if res_name in patch.apply_to_residues:
                    to_apply.append(pname)
            for pname in sorted(set(to_apply)):
                if pname not in self.patches:
                    continue
                suffix = 0
                while True:
                    sfx = "" if suffix == 0 else f"_{suffix}"
                    patched_name = f"{res_name}_{pname}{sfx}"
                    if patched_name not in self.residues:
                        break
                    suffix += 1
                patched = _apply_residue_patch(
                    self.residues[res_name], self.patches[pname],
                    patched_name, self.strictness)
                if patched is not None:
                    self.residues[patched_name] = patched

    # -- resolution ----------------------------------------------------------

    def _index(self):
        self.type_to_class = {n: t.clazz for n, t in self.atom_types.items()}
        # nonbonded lookup by type then class (later entries override)
        self._nb_by_type = {}
        self._nb_by_class = {}
        for e in self.nonbonded:
            if e.pattern.kind == TYPE:
                self._nb_by_type[e.pattern.value] = e
            elif e.pattern.kind == CLASS:
                self._nb_by_class[e.pattern.value] = e
        self._lj_by_type = {}
        self._lj_by_class = {}
        for e in self.lj_entries:
            if e.pattern.kind == TYPE:
                self._lj_by_type[e.pattern.value] = e
            elif e.pattern.kind == CLASS:
                self._lj_by_class[e.pattern.value] = e
        self._templates_by_nameset: Dict[frozenset, List[str]] = {}
        for t in self.residues.values():
            self._templates_by_nameset.setdefault(t.atom_names, []).append(t.name)

    def nonbonded_params(self, type_name):
        return self._memo(("nb", type_name),
                          lambda: self._nonbonded_params(type_name))

    def _nonbonded_params(self, type_name):
        e = self._nb_by_type.get(type_name)
        if e is None:
            e = self._nb_by_class.get(self.type_to_class.get(type_name, ""))
        if self.lj_entries:
            lj = self._lj_by_type.get(type_name)
            if lj is None:
                lj = self._lj_by_class.get(self.type_to_class.get(type_name, ""))
            sigma = lj.sigma if lj else 1.0
            epsilon = lj.epsilon if lj else 0.0
            return sigma, epsilon, (e.charge if e else None)
        if e is None:
            return 1.0, 0.0, None  # OpenMM default sigma=1 eps=0
        return e.sigma, e.epsilon, e.charge

    def find_template(self, res_name, atom_names, external_counts=None):
        """Template whose atom-name set equals the residue's, disambiguated
        by the per-atom external-bond pattern when given (e.g. CYX vs CYM
        share an atom-name set and differ only in SG's external bond).

        external_counts: dict atom_name -> number of bonds leaving the
        residue. The reference does full VF2 graph matching
        (residues.jl:383-603); name-set matching covers canonically-named
        inputs, with graph matching as the fallback (find_template_by_graph).
        """
        key = frozenset(atom_names)
        cands = self._templates_by_nameset.get(key, [])
        if external_counts is not None and len(cands) > 1:
            def ext_ok(tname):
                t = self.residues[tname]
                t_ext = {}
                for e in t.external:
                    t_ext[t.atoms[e].name] = t_ext.get(t.atoms[e].name, 0) + 1
                res_ext = {k: v for k, v in external_counts.items() if v > 0}
                return t_ext == res_ext

            filtered = [c for c in cands if ext_ok(c)]
            if filtered:
                cands = filtered
        if len(cands) == 1:
            return self.residues[cands[0]]
        if len(cands) > 1:
            for pref in (res_name, "N" + res_name, "C" + res_name):
                if pref in cands:
                    return self.residues[pref]
            return self.residues[cands[0]]
        raise KeyError(
            f"no residue template matches {res_name} with atoms {sorted(atom_names)}")

    def _memo(self, key, fn):
        # distinct type tuples number in the hundreds while terms number in
        # the tens of thousands, so memoizing the linear rule scans turns
        # minutes of setup into milliseconds
        cache = self.__dict__.setdefault("_resolve_cache", {})
        if key not in cache:
            cache[key] = fn()
        return cache[key]

    def resolve_bond(self, t1, t2):
        return self._memo(("b", t1, t2), lambda: self._resolve_bond(t1, t2))

    def _resolve_bond(self, t1, t2):
        best = None
        for r in self.bond_rules:
            if ((r.p1.matches(t1, self.type_to_class) and r.p2.matches(t2, self.type_to_class))
                    or (r.p1.matches(t2, self.type_to_class) and r.p2.matches(t1, self.type_to_class))):
                best = r
        return best

    def resolve_angle(self, t1, t2, t3):
        return self._memo(("a", t1, t2, t3),
                          lambda: self._resolve_angle(t1, t2, t3))

    def _resolve_angle(self, t1, t2, t3):
        best = None
        for r in self.angle_rules:
            if r.p2.matches(t2, self.type_to_class) and (
                (r.p1.matches(t1, self.type_to_class) and r.p3.matches(t3, self.type_to_class))
                or (r.p1.matches(t3, self.type_to_class) and r.p3.matches(t1, self.type_to_class))):
                best = r
        return best

    def resolve_proper(self, t1, t2, t3, t4):
        return self._memo(("p", t1, t2, t3, t4),
                          lambda: self._resolve_proper(t1, t2, t3, t4))

    def _resolve_proper(self, t1, t2, t3, t4):
        """Exact match wins immediately; otherwise most specific wildcard
        match, trying forward and reversed (force_field.jl:183-232)."""
        ttc = self.type_to_class
        best, bestspec = None, -1
        for rules in (self.torsion_rules, self.rb_rules):
            for order in ((t1, t2, t3, t4), (t4, t3, t2, t1)):
                for r in rules:
                    if not r.proper:
                        continue
                    if all(p.matches(t, ttc) for p, t in zip(r.patterns, order)):
                        if not r.has_wild:
                            return r
                        if r.specificity > bestspec:
                            bestspec, best = r.specificity, r
        return best

    def resolve_improper(self, tc, t2, t3, t4):
        return self._memo(("i", tc, t2, t3, t4),
                          lambda: self._resolve_improper(tc, t2, t3, t4))

    def _resolve_improper(self, tc, t2, t3, t4):
        """Central atom first; scan the six peripheral permutations
        (force_field.jl:235-295). Returns (rule, perm) where perm maps rule
        positions 2..4 to source positions (1-indexed like the reference)."""
        ttc = self.type_to_class
        best, bestspec, bestperm = None, -1, (1, 2, 3, 4)
        perms = (
            (t2, t3, t4, (1, 2, 3, 4)),
            (t2, t4, t3, (1, 2, 4, 3)),
            (t3, t2, t4, (1, 3, 2, 4)),
            (t3, t4, t2, (1, 3, 4, 2)),
            (t4, t2, t3, (1, 4, 2, 3)),
            (t4, t3, t2, (1, 4, 3, 2)),
        )
        for rules in (self.torsion_rules, self.rb_rules):
            for (q2, q3, q4, perm) in perms:
                for r in rules:
                    if r.proper:
                        continue
                    if not r.patterns[0].matches(tc, ttc):
                        continue
                    if (r.patterns[1].matches(q2, ttc) and r.patterns[2].matches(q3, ttc)
                            and r.patterns[3].matches(q4, ttc)):
                        if not r.has_wild:
                            return r, perm
                        if r.specificity > bestspec:
                            bestspec, best, bestperm = r.specificity, r, perm
        return (best, bestperm) if best is not None else (None, None)

    def resolve_cmap(self, t1, t2, t3, t4, t5):
        return self._memo(("c", t1, t2, t3, t4, t5),
                          lambda: self._resolve_cmap(t1, t2, t3, t4, t5))

    def _resolve_cmap(self, t1, t2, t3, t4, t5):
        ttc = self.type_to_class
        best, bestspec = None, -1
        for r in self.cmap_rules:
            if all(p.matches(t, ttc) for p, t in zip(r.patterns, (t1, t2, t3, t4, t5))):
                if not r.has_wild:
                    return r
                if r.specificity > bestspec:
                    bestspec, best = r.specificity, r
        return best


# -- graph-based template matching (fallback when atom names differ) ----------

def _graph_match(t_elems, t_adj, t_ext, r_elems, r_adj, r_ext):
    """Element-labeled graph isomorphism between a template and a residue
    (the reference does VF2, residues.jl:383-603). Returns mapping
    template_idx -> residue_idx or None. Small graphs; backtracking with
    element/degree/external pruning."""
    n = len(t_elems)
    if n != len(r_elems):
        return None
    if sorted(t_elems) != sorted(r_elems):
        return None
    # order template atoms: start from highest degree, then by connectivity
    order = sorted(range(n), key=lambda i: -len(t_adj[i]))
    ordered = []
    seen = set()
    while len(ordered) < n:
        nxt = None
        for i in order:
            if i in seen:
                continue
            if not ordered or any(j in seen for j in t_adj[i]):
                nxt = i
                break
        if nxt is None:
            nxt = next(i for i in order if i not in seen)
        ordered.append(nxt)
        seen.add(nxt)

    mapping = {}
    used = set()

    def feasible(ti, ri):
        if t_elems[ti] != r_elems[ri]:
            return False
        if len(t_adj[ti]) != len(r_adj[ri]):
            return False
        if t_ext[ti] != r_ext[ri]:
            return False
        for tj in t_adj[ti]:
            if tj in mapping and mapping[tj] not in r_adj[ri]:
                return False
        for tj in mapping:
            if tj in t_adj[ti]:
                continue
            if mapping[tj] in r_adj[ri]:
                return False
        return True

    def backtrack(pos):
        if pos == len(ordered):
            return True
        ti = ordered[pos]
        for ri in range(n):
            if ri in used:
                continue
            if feasible(ti, ri):
                mapping[ti] = ri
                used.add(ri)
                if backtrack(pos + 1):
                    return True
                del mapping[ti]
                used.discard(ri)
        return False

    if backtrack(0):
        return dict(mapping)
    return None


def _template_graph(ff, tmpl):
    elems = [ff.atom_types[a.type].element for a in tmpl.atoms]
    adj = [set() for _ in tmpl.atoms]
    for (a, b) in tmpl.bonds:
        adj[a].add(b)
        adj[b].add(a)
    ext = [0] * len(tmpl.atoms)
    for e in tmpl.external:
        ext[e] += 1
    return elems, adj, ext


def find_template_by_graph(ff, res_name, elements, internal_bonds, external_counts):
    """Graph-match a residue against all templates with compatible element
    multisets. internal_bonds: local (i, j) pairs; external_counts: per-atom
    number of bonds leaving the residue. Returns (template, mapping
    template_idx -> local_idx)."""
    n = len(elements)
    r_adj = [set() for _ in range(n)]
    for (a, b) in internal_bonds:
        r_adj[a].add(b)
        r_adj[b].add(a)
    key = sorted(elements)
    names_pref = [res_name, "N" + res_name, "C" + res_name]
    cands = sorted(
        (t for t in ff.residues.values() if len(t.atoms) == n),
        key=lambda t: (t.name not in names_pref,))
    for tmpl in cands:
        t_elems, t_adj, t_ext = _template_graph(ff, tmpl)
        if sorted(t_elems) != key:
            continue
        mapping = _graph_match(t_elems, t_adj, t_ext, elements, r_adj,
                               list(external_counts))
        if mapping is not None:
            return tmpl, mapping
    raise KeyError(
        f"no residue template graph-matches {res_name} "
        f"(elements {key}, {len(internal_bonds)} bonds)")


# covalent radii (nm) for distance-based bond detection
COVALENT_RADII = {
    "H": 0.031, "C": 0.076, "N": 0.071, "O": 0.066, "S": 0.105, "P": 0.107,
    "F": 0.057, "Cl": 0.102, "CL": 0.102, "Br": 0.120, "BR": 0.120,
    "I": 0.139, "Na": 0.166, "NA": 0.166, "K": 0.203, "Mg": 0.141,
    "MG": 0.141, "Ca": 0.176, "CA": 0.176, "Zn": 0.122, "ZN": 0.122,
    "Fe": 0.132, "FE": 0.132, "Se": 0.120, "?": 0.077,
}


def detect_bonds(coords, elements, tolerance=1.25):
    """Distance-based covalent bond detection with cell binning (used to
    build the topology graph before template matching; the reference instead
    ships OpenMM's residues.xml standard-bond templates)."""
    import numpy as _np
    coords = _np.asarray(coords)
    n = coords.shape[0]
    radii = _np.array([COVALENT_RADII.get(e, 0.077) for e in elements])
    max_bond = tolerance * 2.0 * radii.max()
    cell = max(max_bond, 0.2)
    keys = _np.floor(coords / cell).astype(_np.int64)
    cells = {}
    for i in range(n):
        cells.setdefault(tuple(keys[i]), []).append(i)
    bonds = []
    offs = [(a, b, c) for a in (-1, 0, 1) for b in (-1, 0, 1) for c in (-1, 0, 1)]
    for (cx, cy, cz), members in cells.items():
        neigh = []
        for (ox, oy, oz) in offs:
            neigh.extend(cells.get((cx + ox, cy + oy, cz + oz), ()))
        neigh = _np.asarray(neigh)
        for i in members:
            d = _np.linalg.norm(coords[neigh] - coords[i], axis=1)
            cut = tolerance * (radii[i] + radii[neigh])
            hits = neigh[(d < cut) & (neigh > i)]
            for j in hits:
                # never bond two hydrogens or two metals
                if elements[i] == "H" and elements[int(j)] == "H":
                    continue
                bonds.append((i, int(j)))
    return sorted(set(bonds))
