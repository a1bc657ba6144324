"""Trajectory writing and re-reading (counterpart of
mollytpu/utils/trajectory.py, whose writers this module matches byte for
byte): PDB (multi-model), XYZ, TRR, mol2, DCD (CHARMM binary) and XTC,
written natively, plus the readers and EnsembleSystem for reanalysis.
A frame's coordinates go to the host once, when it is written.
"""

from __future__ import annotations

import dataclasses
import struct

import numpy as np
import torch


def _host(x):
    """A numpy array of the tensor x, which may be on the card."""
    return x.detach().cpu().numpy()


class TrajectoryWriter:
    """Logger-compatible trajectory writer: pass in the loggers dict as
    ``{"traj": TrajectoryWriter(interval, path)}``; format from the file
    extension (.pdb, .xyz, .dcd, .trr, .mol2, .xtc). Frames are appended
    to the file."""

    def __init__(self, interval, path, atom_data=None):
        self.interval = int(interval)
        self.needs_virial_interval = 0
        self.path = str(path)
        self.atom_data = atom_data
        self.n_written = 0
        self._fh = None
        fmt = self.path.rsplit(".", 1)[-1].lower()
        if fmt not in ("pdb", "xyz", "dcd", "trr", "mol2", "xtc"):
            raise ValueError(f"unsupported trajectory format .{fmt}")
        self.fmt = fmt

    def observe(self, sys, neighbors, aux, step_n):
        coords = _host(sys.coords)
        box = _host(sys.boundary.side_lengths)
        if self.fmt == "pdb":
            self._write_pdb(coords, box)
        elif self.fmt == "xyz":
            self._write_xyz(coords)
        elif self.fmt == "trr":
            self._write_trr(coords, box, _host(sys.velocities)
                            if sys.velocities is not None else None, step_n)
        elif self.fmt == "mol2":
            self._write_mol2(coords)
        elif self.fmt == "xtc":
            from .xtc import write_xtc_frame
            bm = _host(sys.boundary.box_matrix())
            with open(self.path, "ab") as f:
                write_xtc_frame(f, coords, bm, int(step_n),
                                float(getattr(sys, "time", 0.0) or 0.0))
        else:
            self._write_dcd(coords, box)
        self.n_written += 1
        return step_n

    # -- PDB ------------------------------------------------------------------

    def _write_pdb(self, coords, box):
        with open(self.path, "a") as f:
            if self.n_written == 0 and np.all(np.isfinite(box)):
                a, b, c = box * 10.0
                f.write(f"CRYST1{a:9.3f}{b:9.3f}{c:9.3f}"
                        f"  90.00  90.00  90.00 P 1           1\n")
            f.write(f"MODEL     {self.n_written + 1:4d}\n")
            ad = self.atom_data
            for i, (x, y, z) in enumerate(coords * 10.0):
                name = ad.atom_name[i] if ad is not None else "X"
                res = ad.residue_name[i] if ad is not None else "UNK"
                rnum = int(ad.residue_number[i]) if ad is not None else 1
                chain = ad.chain_id[i] if ad is not None else "A"
                el = ad.element[i] if ad is not None else "X"
                nm = f" {name:<3s}" if len(name) < 4 else name[:4]
                f.write(f"ATOM  {i + 1 if i < 99999 else 99999:5d} {nm}"
                        f" {res:<4s}{chain}{rnum:4d}    "
                        f"{x:8.3f}{y:8.3f}{z:8.3f}  1.00  0.00"
                        f"          {el:>2s}\n")
            f.write("ENDMDL\n")

    # -- XYZ ------------------------------------------------------------------

    def _write_xyz(self, coords):
        with open(self.path, "a") as f:
            f.write(f"{coords.shape[0]}\nframe {self.n_written}\n")
            ad = self.atom_data
            for i, (x, y, z) in enumerate(coords * 10.0):
                el = ad.element[i] if ad is not None else "X"
                f.write(f"{el} {x:.5f} {y:.5f} {z:.5f}\n")

    # -- TRR (GROMACS trajectory, big-endian XDR-style) ------------------------

    def _write_trr(self, coords, box, vels, step_n):
        """Uncompressed GROMACS .trr frame (format: GROMACS manual B.2)."""
        n = coords.shape[0]
        x_size = n * 3 * 4
        v_size = x_size if vels is not None else 0
        box_size = 9 * 4
        with open(self.path, "ab") as f:
            f.write(struct.pack(">i", 1993))          # magic
            f.write(struct.pack(">i", 13))            # version
            tag = b"GMX_trn_file"
            f.write(struct.pack(">i", len(tag) + 1))
            f.write(struct.pack(">i", len(tag)))
            f.write(tag)
            # ir/e/box/vir/pres/top/sym/x/v/f sizes
            for v in (0, 0, box_size, 0, 0, 0, 0, x_size, v_size, 0):
                f.write(struct.pack(">i", v))
            f.write(struct.pack(">i", n))
            f.write(struct.pack(">i", int(step_n)))
            f.write(struct.pack(">i", 0))             # nre
            f.write(struct.pack(">f", 0.0))           # time
            f.write(struct.pack(">f", 0.0))           # lambda
            bm = np.zeros((3, 3), dtype=">f4")
            bm[0, 0], bm[1, 1], bm[2, 2] = box[0], box[1], box[2]
            f.write(bm.tobytes())
            f.write(np.asarray(coords, dtype=">f4").tobytes())
            if vels is not None:
                f.write(np.asarray(vels, dtype=">f4").tobytes())

    # -- mol2 ------------------------------------------------------------------

    def _write_mol2(self, coords):
        """SYBYL mol2 frame (appends one @<TRIPOS>MOLECULE block)."""
        names = (self.atom_data.atom_name if self.atom_data is not None
                 else [f"A{i+1}" for i in range(coords.shape[0])])
        elems = [str(nm)[0] for nm in names]
        with open(self.path, "a") as f:
            f.write("@<TRIPOS>MOLECULE\n")
            f.write(f"frame_{self.n_written}\n")
            f.write(f"{coords.shape[0]} 0 0 0 0\n")
            f.write("SMALL\nNO_CHARGES\n")
            f.write("@<TRIPOS>ATOM\n")
            for i, c in enumerate(coords):
                f.write(f"{i+1:>7d} {str(names[i % len(names)]):<6s}"
                        f"{c[0]*10:>10.4f}{c[1]*10:>10.4f}{c[2]*10:>10.4f}"
                        f" {elems[i % len(elems)]}\n")

    # -- DCD (CHARMM binary) ----------------------------------------------------

    def _dcd_header(self, n_atoms):
        h = struct.pack("<i4s9if10i", 84, b"CORD", 0, 0, self.interval, 0, 0,
                        0, 0, 0, 0, 0.0, 1, 0, 0, 0, 0, 0, 0, 0, 0, 24)
        h += struct.pack("<i", 84)
        title = b"Created by mollytpu".ljust(80)
        h += struct.pack("<ii", 84, 1) + title + struct.pack("<i", 84)
        h += struct.pack("<iii", 4, n_atoms, 4)
        return h

    def _write_dcd(self, coords, box):
        n = coords.shape[0]
        mode = "ab" if self.n_written else "wb"
        with open(self.path, mode) as f:
            if self.n_written == 0:
                f.write(self._dcd_header(n))
            # unit cell record (48 bytes: a, gamma, b, beta, alpha, c)
            a, b, c = (box * 10.0).tolist() if np.all(np.isfinite(box)) \
                else (0.0, 0.0, 0.0)
            f.write(struct.pack("<i6di", 48, a, 90.0, b, 90.0, 90.0, c, 48))
            for axis in range(3):
                data = (coords[:, axis] * 10.0).astype("<f4").tobytes()
                f.write(struct.pack("<i", 4 * n) + data + struct.pack("<i", 4 * n))


def read_xyz_frames(path):
    """Re-read an XYZ trajectory -> (T, N, 3) nm."""
    frames = []
    with open(path) as f:
        while True:
            line = f.readline()
            if not line:
                break
            n = int(line.strip())
            f.readline()
            frame = np.zeros((n, 3))
            for i in range(n):
                parts = f.readline().split()
                frame[i] = [float(p) / 10.0 for p in parts[1:4]]
            frames.append(frame)
    return np.stack(frames)


def read_pdb_frames(path):
    """Re-read a multi-model PDB -> (T, N, 3) nm."""
    frames = []
    cur = []
    for line in open(path):
        if line.startswith(("ATOM", "HETATM")):
            cur.append([float(line[30:38]) / 10.0, float(line[38:46]) / 10.0,
                        float(line[46:54]) / 10.0])
        elif line.startswith("ENDMDL"):
            frames.append(np.asarray(cur))
            cur = []
    if cur:
        frames.append(np.asarray(cur))
    return np.stack(frames)


def read_trr_frames(path):
    """Read frames written by the TRR writer. Returns (T, N, 3) coords."""
    frames = []
    with open(path, "rb") as f:
        while True:
            head = f.read(8)
            if len(head) < 8:
                break
            magic, version = struct.unpack(">ii", head)
            assert magic == 1993, "not a TRR file"
            tlen, slen = struct.unpack(">ii", f.read(8))
            f.read(slen)
            sizes = struct.unpack(">10i", f.read(40))
            (ir_s, e_s, box_s, vir_s, pres_s, top_s, sym_s,
             x_s, v_s, f_s) = sizes
            n, step, nre = struct.unpack(">iii", f.read(12))
            f.read(8)  # time, lambda
            f.read(box_s + vir_s + pres_s)
            if x_s:
                x = np.frombuffer(f.read(x_s), dtype=">f4").reshape(n, 3)
                frames.append(np.asarray(x, np.float32))
            f.read(v_s + f_s)
    return np.stack(frames)


def read_dcd_frames(path):
    """Re-read a DCD trajectory written by TrajectoryWriter -> (T, N, 3) nm."""
    frames = []
    with open(path, "rb") as f:
        raw = f.read()
    off = 0
    (blk,) = struct.unpack_from("<i", raw, off)
    off += 4 + blk + 4
    (blk,) = struct.unpack_from("<i", raw, off)
    off += 4 + blk + 4
    (blk, n_atoms, _) = struct.unpack_from("<iii", raw, off)
    off += 12
    while off < len(raw):
        off += 4 + 48 + 4  # unit cell
        frame = np.zeros((n_atoms, 3))
        for axis in range(3):
            off += 4
            frame[:, axis] = np.frombuffer(raw, dtype="<f4", count=n_atoms,
                                           offset=off) / 10.0
            off += 4 * n_atoms + 4
        frames.append(frame)
    return np.stack(frames)


@dataclasses.dataclass
class EnsembleSystem:
    """Reanalysis helper: a System template + a stack of trajectory
    frames; ``frame(t)`` is the system at frame t."""

    sys: object
    frames: np.ndarray  # (T, N, 3)

    @classmethod
    def from_file(cls, sys, path):
        fmt = path.rsplit(".", 1)[-1].lower()
        reader = {"xyz": read_xyz_frames, "pdb": read_pdb_frames,
                  "dcd": read_dcd_frames,
                  "trr": read_trr_frames,
                  "xtc": read_xtc_coords}[fmt]
        return cls(sys=sys, frames=reader(path))

    def frame(self, t):
        return self.sys.update(coords=torch.as_tensor(
            self.frames[t], dtype=self.sys.coords.dtype,
            device=self.sys.device))

    def __len__(self):
        return self.frames.shape[0]


def read_xtc_coords(path):
    from .xtc import read_xtc_frames
    return np.stack([f[0] for f in read_xtc_frames(path)])
