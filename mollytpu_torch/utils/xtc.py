"""XTC trajectory format: the GROMACS 3dfcoord compressed coordinate codec.

Pure-Python/NumPy reimplementation of the libxdrfile algorithm (magicints
base compression + small-delta run encoding); the port's own copy of
mollytpu/utils/xtc.py, byte for byte its writer. Coordinates round-trip to
within 0.5/precision nm (default precision 1000 -> 0.0005 nm).

Layout per frame (all big-endian XDR):
  magic=1995, natoms, step, time, box 3x3 f32, natoms, precision,
  minint[3], maxint[3], smallidx, nbytes, <compressed stream padded to 4>.
"""

from __future__ import annotations

import struct

import numpy as np

MAGIC = 1995

MAGICINTS = [
    0, 0, 0, 0, 0, 0, 0, 0, 0, 8, 10, 12, 16, 20, 25, 32, 40, 50, 64, 80,
    101, 128, 161, 203, 256, 322, 406, 512, 645, 812, 1024, 1290, 1625,
    2048, 2580, 3250, 4096, 5060, 6501, 8192, 10321, 13003, 16384, 20642,
    26007, 32768, 41285, 52015, 65536, 82570, 104031, 131072, 165140,
    208063, 262144, 330280, 416127, 524287, 660561, 832255, 1048576,
    1321122, 1664510, 2097152, 2642245, 3329021, 4194304, 5284491, 6658042,
    8388607, 10568983, 13316085, 16777216,
]
FIRSTIDX = 9
LASTIDX = len(MAGICINTS)


def _sizeofint(size):
    num = 1
    nbits = 0
    while size >= num and nbits < 32:
        nbits += 1
        num <<= 1
    return nbits


def _sizeofints(sizes):
    nbytes = 1
    bts = [1]
    nbits = 0
    for size in sizes:
        tmp = 0
        for i in range(nbytes):
            tmp = bts[i] * size + tmp
            bts[i] = tmp & 0xFF
            tmp >>= 8
        while tmp:
            if nbytes < len(bts):
                bts[nbytes] = tmp & 0xFF
            else:
                bts.append(tmp & 0xFF)
            nbytes += 1
            tmp >>= 8
        if nbytes > len(bts):
            bts += [0] * (nbytes - len(bts))
    num = 1
    nbytes -= 1
    while bts[nbytes] >= num:
        nbits += 1
        num *= 2
    return nbits + nbytes * 8


#: the bit buffers keep their low 16 bits: libxdrfile's are 32-bit
#: integers, and a field reads at most the 8 bits above fewer than 8
#: pending ones. An unbounded Python int would grow with the frame and
#: make each shift, so the whole frame, cost O(N^2).
_BUFFER = 0xFFFF


class _BitWriter:
    def __init__(self):
        self.bytes = bytearray()
        self.lastbits = 0
        self.lastbyte = 0

    def bits(self, nbits, value):
        value &= (1 << nbits) - 1 if nbits < 64 else ~0
        while nbits >= 8:
            self.lastbyte = ((self.lastbyte << 8) & _BUFFER
                             | ((value >> (nbits - 8)) & 0xFF))
            self.bytes.append((self.lastbyte >> self.lastbits) & 0xFF)
            nbits -= 8
        if nbits > 0:
            self.lastbyte = ((self.lastbyte << nbits) & _BUFFER
                             | (value & ((1 << nbits) - 1)))
            self.lastbits += nbits
            if self.lastbits >= 8:
                self.lastbits -= 8
                self.bytes.append((self.lastbyte >> self.lastbits) & 0xFF)

    def ints(self, nbits, sizes, nums):
        bts = []
        tmp = int(nums[0])
        while True:
            bts.append(tmp & 0xFF)
            tmp >>= 8
            if not tmp:
                break
        for i in range(1, len(nums)):
            tmp = int(nums[i])
            for j in range(len(bts)):
                tmp = bts[j] * int(sizes[i]) + tmp
                bts[j] = tmp & 0xFF
                tmp >>= 8
            while tmp:
                bts.append(tmp & 0xFF)
                tmp >>= 8
        nbytes = len(bts)
        if nbits >= nbytes * 8:
            for b in bts:
                self.bits(8, b)
            self.bits(nbits - nbytes * 8, 0)
        else:
            for b in bts[:-1]:
                self.bits(8, b)
            self.bits(nbits - (nbytes - 1) * 8, bts[-1])

    def flush(self):
        if self.lastbits > 0:
            self.bytes.append((self.lastbyte << (8 - self.lastbits)) & 0xFF)
            self.lastbits = 0
        return bytes(self.bytes)


class _BitReader:
    def __init__(self, data):
        self.data = data
        self.cnt = 0
        self.lastbits = 0
        self.lastbyte = 0

    def bits(self, nbits):
        mask = (1 << nbits) - 1
        num = 0
        while nbits >= 8:
            self.lastbyte = ((self.lastbyte << 8) & _BUFFER
                             | self.data[self.cnt])
            self.cnt += 1
            num |= (self.lastbyte >> self.lastbits) << (nbits - 8)
            nbits -= 8
        if nbits > 0:
            if self.lastbits < nbits:
                self.lastbits += 8
                self.lastbyte = ((self.lastbyte << 8) & _BUFFER
                                 | self.data[self.cnt])
                self.cnt += 1
            self.lastbits -= nbits
            num |= (self.lastbyte >> self.lastbits) & ((1 << nbits) - 1)
        return num & mask

    def ints(self, nbits, sizes):
        n = len(sizes)
        bts = []
        while nbits > 8:
            bts.append(self.bits(8))
            nbits -= 8
        if nbits > 0:
            bts.append(self.bits(nbits))
        nums = [0] * n
        for i in range(n - 1, 0, -1):
            num = 0
            for j in range(len(bts) - 1, -1, -1):
                num = (num << 8) | bts[j]
                p = num // int(sizes[i])
                bts[j] = p
                num = num - p * int(sizes[i])
            nums[i] = num
        nums[0] = 0
        for j in range(len(bts) - 1, -1, -1):
            nums[0] = (nums[0] << 8) | bts[j]
        return nums


def compress_coords(coords, precision=1000.0):
    """coords (N, 3) float nm -> (minint, maxint, smallidx, payload bytes).

    Implements the libxdrfile small-run delta scheme: each base atom is
    written against the frame bounding box; up to 8 following atoms whose
    deltas fit the adaptive "small" size are written as deltas, with the
    water-style swap of the base atom and its first near neighbor.
    """
    ints = np.rint(np.asarray(coords, dtype=np.float64)
                   * precision).astype(np.int64)
    n = ints.shape[0]
    minint = ints.min(axis=0)
    maxint = ints.max(axis=0)
    sizeint = [int(maxint[d] - minint[d] + 1) for d in range(3)]
    if any(s > 0xFFFFFF for s in sizeint):
        bitsizeint = [_sizeofint(s) for s in sizeint]
        bitsize = 0
    else:
        bitsizeint = [0, 0, 0]
        bitsize = _sizeofints(sizeint)

    diffs = np.abs(np.diff(ints, axis=0)).sum(axis=1)
    mindiff = int(diffs.min()) if len(diffs) else 0
    smallidx = FIRSTIDX
    while smallidx < LASTIDX - 1 and MAGICINTS[smallidx] < mindiff:
        smallidx += 1
    smallidx0 = smallidx   # header value: the INITIAL index (the in-loop
                           # adaptive updates mutate smallidx)
    maxidx = min(LASTIDX - 1, smallidx + 8)
    minidx = maxidx - 8
    smaller = MAGICINTS[max(FIRSTIDX, smallidx - 1)] // 2
    smallnum = MAGICINTS[smallidx] // 2
    sizesmall = [MAGICINTS[smallidx]] * 3
    larger = MAGICINTS[maxidx] // 2

    w = _BitWriter()
    lip = [list(map(int, row)) for row in ints]
    prevcoord = [0, 0, 0]
    prevrun = -1   # libxdrfile: flag bit encodes "run-length changed"
    i = 0
    while i < n:
        thiscoord = lip[i][:]
        is_smaller = 0
        if smallidx < maxidx and i >= 1 and all(
                abs(thiscoord[d] - prevcoord[d]) < larger for d in range(3)):
            is_smaller = 1
        elif smallidx > minidx:
            is_smaller = -1
        is_small = 0
        if i + 1 < n and all(
                abs(thiscoord[d] - lip[i + 1][d]) < smallnum
                for d in range(3)):
            # swap: write the neighbor as the base, this atom as 1st delta
            lip[i], lip[i + 1] = lip[i + 1], lip[i]
            thiscoord = lip[i][:]
            is_small = 1
        tmpc = [thiscoord[d] - int(minint[d]) for d in range(3)]
        if bitsize == 0:
            for d in range(3):
                w.bits(bitsizeint[d], tmpc[d])
        else:
            w.ints(bitsize, sizeint, tmpc)
        prevcoord = thiscoord[:]
        i += 1

        run = 0
        runbuf = []
        if is_small == 0 and is_smaller == -1:
            is_smaller = 0
        while is_small and run < 8 * 3:
            thiscoord = lip[i][:]
            if is_smaller == -1 and (
                    sum((thiscoord[d] - prevcoord[d]) ** 2
                        for d in range(3))
                    >= smaller * smaller):
                is_smaller = 0
            for d in range(3):
                runbuf.append(thiscoord[d] - prevcoord[d] + smallnum)
            run += 3
            prevcoord = thiscoord[:]
            i += 1
            is_small = 0
            if i < n and all(
                    abs(lip[i][d] - prevcoord[d]) < smallnum
                    for d in range(3)):
                is_small = 1
        # libxdrfile semantics: flag=1 signals "run-length changed (or
        # smallidx adjustment)"; the run smallints are ALWAYS written
        # whenever run > 0, even under flag=0 (run persisted from before).
        if run != prevrun or is_smaller != 0:
            prevrun = run
            w.bits(1, 1)
            w.bits(5, run + is_smaller + 1)
        else:
            w.bits(1, 0)
        for k in range(0, run, 3):
            w.ints(smallidx, sizesmall, runbuf[k:k + 3])
        if is_smaller:
            # libxdrfile incremental update (note smaller -> 0 at FIRSTIDX)
            smallidx += is_smaller
            if is_smaller < 0:
                smallnum = smaller
                smaller = (MAGICINTS[smallidx - 1] // 2
                           if smallidx > FIRSTIDX else 0)
            else:
                smaller = smallnum
                smallnum = MAGICINTS[smallidx] // 2
            sizesmall = [MAGICINTS[smallidx]] * 3

    payload = w.flush()
    return ([int(x) for x in minint], [int(x) for x in maxint],
            smallidx0, payload, bitsize, bitsizeint, sizeint)


def decompress_coords(n, minint, maxint, smallidx0, payload,
                      precision=1000.0):
    sizeint = [maxint[d] - minint[d] + 1 for d in range(3)]
    if any(s > 0xFFFFFF for s in sizeint):
        bitsizeint = [_sizeofint(s) for s in sizeint]
        bitsize = 0
    else:
        bitsizeint = [0, 0, 0]
        bitsize = _sizeofints(sizeint)
    smallidx = smallidx0
    maxidx = min(LASTIDX - 1, smallidx + 8)
    minidx = maxidx - 8
    smaller = MAGICINTS[max(FIRSTIDX, smallidx - 1)] // 2
    smallnum = MAGICINTS[smallidx] // 2
    sizesmall = [MAGICINTS[smallidx]] * 3

    r = _BitReader(payload)
    out = np.zeros((n, 3), dtype=np.float64)
    i = 0
    run = 0   # persists across atoms: flag==0 means "run-length unchanged"
    while i < n:
        if bitsize == 0:
            thiscoord = [r.bits(bitsizeint[d]) for d in range(3)]
        else:
            thiscoord = r.ints(bitsize, sizeint)
        thiscoord = [thiscoord[d] + minint[d] for d in range(3)]
        prevcoord = thiscoord[:]
        flag = r.bits(1)
        is_smaller = 0
        if flag:
            v = r.bits(5)
            is_smaller = v % 3
            run = v - is_smaller
            is_smaller -= 1
        if run > 0:
            for k in range(0, run, 3):
                small = r.ints(smallidx, sizesmall)
                small = [small[d] + prevcoord[d] - smallnum
                         for d in range(3)]
                if k == 0:
                    # un-swap: the first delta atom precedes the base atom
                    out[i] = np.asarray(small) / precision
                    i += 1
                    out[i] = np.asarray(thiscoord) / precision
                    i += 1
                    prevcoord = small
                else:
                    prevcoord = small
                    out[i] = np.asarray(small) / precision
                    i += 1
        else:
            out[i] = np.asarray(thiscoord) / precision
            i += 1
        if is_smaller:
            smallidx += is_smaller
            if is_smaller < 0:
                smallnum = smaller
                smaller = (MAGICINTS[smallidx - 1] // 2
                           if smallidx > FIRSTIDX else 0)
            else:
                smaller = smallnum
                smallnum = MAGICINTS[smallidx] // 2
            sizesmall = [MAGICINTS[smallidx]] * 3
    return out


def write_xtc_frame(fh, coords, box_matrix, step, time_ps, precision=1000.0):
    coords = np.asarray(coords, dtype=np.float64)
    n = coords.shape[0]
    fh.write(struct.pack(">iii f", MAGIC, n, step, float(time_ps)))
    box = np.asarray(box_matrix, dtype=np.float32).reshape(3, 3)
    fh.write(struct.pack(">9f", *box.reshape(-1)))
    fh.write(struct.pack(">i", n))
    if n <= 9:
        for row in coords:
            fh.write(struct.pack(">3f", *row))
        return
    fh.write(struct.pack(">f", float(precision)))
    (minint, maxint, smallidx, payload, _, _, _) = compress_coords(
        coords, precision)
    fh.write(struct.pack(">3i", *minint))
    fh.write(struct.pack(">3i", *maxint))
    fh.write(struct.pack(">i", smallidx))
    fh.write(struct.pack(">i", len(payload)))
    fh.write(payload)
    pad = (-len(payload)) % 4
    fh.write(b"\x00" * pad)


def read_xtc_frames(path):
    """Read all frames: returns list of (coords (N,3), box (3,3), step,
    time)."""
    frames = []
    with open(path, "rb") as fh:
        while True:
            head = fh.read(16)
            if len(head) < 16:
                break
            magic, n, step, t = struct.unpack(">iii f", head)
            if magic != MAGIC:
                raise ValueError(f"bad XTC magic {magic}")
            box = np.asarray(struct.unpack(">9f", fh.read(36))).reshape(3, 3)
            n2 = struct.unpack(">i", fh.read(4))[0]
            if n <= 9:
                coords = np.asarray(
                    [struct.unpack(">3f", fh.read(12)) for _ in range(n)])
                frames.append((coords, box, step, t))
                continue
            prec = struct.unpack(">f", fh.read(4))[0]
            minint = list(struct.unpack(">3i", fh.read(12)))
            maxint = list(struct.unpack(">3i", fh.read(12)))
            smallidx = struct.unpack(">i", fh.read(4))[0]
            nbytes = struct.unpack(">i", fh.read(4))[0]
            payload = fh.read(nbytes)
            fh.read((-nbytes) % 4)
            coords = decompress_coords(n, minint, maxint, smallidx, payload,
                                       prec)
            frames.append((coords, box, step, t))
    return frames
