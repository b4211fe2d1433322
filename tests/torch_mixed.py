"""One mixed-scheme reference segment for the parity tests of the port:
every integer column scheme (CONST, RAW, BITPACK narrow and wide, DELTA,
RLE, DICT with integer and bytes dictionaries) in a few small packs,
built by knoxdb_tpu and carried into knoxdb_tpu_torch with
segment_from_reference, so that both engines scan the very same packs."""

import numpy as np

from knoxdb_tpu.encode import select as RSel
from knoxdb_tpu.encode.schemes import Scheme as RScheme
from knoxdb_tpu.exec.device import DeviceSegment as RDevSeg
from knoxdb_tpu.exec.scan import SegmentScanner as RScanner
from knoxdb_tpu.pack.segment import build_segment as r_build
from knoxdb_tpu.query import filter as RQ
from knoxdb_tpu.schema.schema import Builder as RBuilder
from knoxdb_tpu.types import FieldType as RFT
from knoxdb_tpu.types import FilterMode as RFM
from knoxdb_tpu.utils import limbs as rlb
from knoxdb_tpu_torch.encode.schemes import Scheme
from knoxdb_tpu_torch.exec.device import DeviceSegment as TDevSeg
from knoxdb_tpu_torch.exec.scan import SegmentScanner as TScanner
from knoxdb_tpu_torch.pack.segment import segment_from_reference
from knoxdb_tpu_torch.query import filter as TQ
from knoxdb_tpu_torch.types import FilterMode as TFM

PACK = 1024
P = 6
COLS = [("d", "UINT64"), ("r", "INT64"), ("w", "INT64"), ("a", "UINT64"),
        ("k", "UINT32"), ("s", "STRING"), ("big", "INT128"),
        ("h", "INT256")]
BIG0 = -(1 << 100) + 12345          # wide BITPACK bases
BIG1 = (1 << 120) + 99
H0 = (1 << 200) - 777


def mixed_data(seed: int = 7):
    rng = np.random.default_rng(seed)
    n = PACK * P
    pack = np.arange(n) // PACK
    runs = np.repeat(rng.integers(-1 << 40, 1 << 40, n // 32),
                     rng.integers(30, 100, n // 32))[:n]
    kvals = (rng.choice(1 << 22, 100, replace=False) * 1000).astype(np.uint32)
    svals = np.array([f"v{i:03d}" for i in range(0, 120, 3)], object)
    big = np.empty(n, object)
    h = np.empty(n, object)
    for i in range(n):
        p = int(pack[i])
        off = int(rng.integers(0, 1 << 40))
        if p == 3:
            big[i] = BIG1 + 5                      # a wide CONST pack
        elif p == 4:                               # a wide RAW pack
            big[i] = int(rng.integers(-1 << 62, 1 << 62)) << 64 | off
        else:
            big[i] = (BIG0 if p < 3 else BIG1) + off
        if p == 1:
            h[i] = (int(rng.integers(-1 << 62, 1 << 62)) << 190) + off
        else:
            h[i] = H0 + p * (1 << 70) + off
    return {
        "id": np.arange(1, n + 1, dtype=np.uint64),
        # DELTA that crosses 2^63
        "d": (np.uint64((1 << 63) - 3000)
              + np.cumsum(rng.integers(1, 4, n)).astype(np.uint64)),
        "r": runs.astype(np.int64),                           # RLE
        "w": rng.integers(-1 << 62, 1 << 62, n, dtype=np.int64),  # RAW
        # narrow BITPACK in two width groups
        "a": np.where(pack < 3, rng.integers(0, 200, n),
                      rng.integers(0, 40_000, n)).astype(np.uint64),
        "k": kvals[rng.integers(0, 100, n)],                  # DICT
        "s": svals[rng.integers(0, len(svals), n)],           # bytes DICT
        "big": big, "h": h,
    }


class Mixed:
    """The segment under both engines, and each engine's filter trees."""

    def __init__(self, seed: int = 7):
        self.data = mixed_data(seed)
        b = RBuilder("mixed").pk("id")
        for name, ft in COLS:
            b = b.add(name, RFT[ft])
        self.rsch = b.finish()
        self.rseg = r_build(self.rsch, self.data, pack_size=PACK)
        # no narrow column ever selects RAW: force it on "w"
        wcol = self.rseg.columns["w"]
        keys = rlb.to_keys64(self.data["w"], RFT.INT64)
        wcol.packs = [RSel.encode_pack(keys[i * PACK:(i + 1) * PACK], 2,
                                       PACK, scheme=RScheme.RAW)
                      for i in range(P)]
        self.tseg = segment_from_reference(self.rseg)
        self.tsch = self.tseg.schema
        self.rsc = RScanner(RDevSeg(self.rseg))
        self.tsc = TScanner(TDevSeg(self.tseg, "cpu"))

    def schemes(self, name):
        return [g.scheme for g in self.tsc.d.column(name).groups]

    def check_schemes(self):
        S = Scheme
        want = {"id": {S.DELTA}, "d": {S.DELTA}, "r": {S.RLE}, "w": {S.RAW},
                "a": {S.BITPACK}, "k": {S.DICT}, "s": {S.DICT},
                "big": {S.BITPACK, S.CONST, S.RAW},
                "h": {S.BITPACK, S.RAW}}
        for name, schemes in want.items():
            assert set(self.schemes(name)) == schemes, (name,
                                                        self.schemes(name))
        assert len(self.tsc.d.column("a").groups) == 2
        assert self.tsc.d.column("big").wide and self.tsc.d.column("h").wide

    def trees(self, spec):
        """spec: ("leaf", field, MODE, value) | ("and" | "or", spec...)."""
        def build(Q, FM, sch, s):
            if s[0] == "leaf":
                return Q.leaf(Q.Filter(sch.field(s[1]), FM[s[2]], s[3]))
            return (Q.and_ if s[0] == "and" else Q.or_)(
                *[build(Q, FM, sch, c) for c in s[1:]])
        return (build(RQ, RFM, self.rsch, spec).optimize(),
                build(TQ, TFM, self.tsch, spec).optimize())

    def masks(self, spec):
        """The packed match mask of both engines, as u32[P, W]."""
        from knoxdb_tpu_torch.ops import words as WD
        rtree, ttree = self.trees(spec)
        rfn, rargs, _raw = self.rsc.prepare(rtree, [])
        tfn, targs = self.tsc.prepare(ttree, [])
        return (np.asarray(rfn(*rargs)[0]),
                WD.from_words(tfn(*targs)[0]))


def oracle_mask(data, field, mode, value):
    """bool[n] of one leaf in the value domain (python compares)."""
    col = data[field]
    x = col if col.dtype == object else col.astype(object)
    if mode == "EQ":
        return x == value
    if mode == "NE":
        return x != value
    if mode == "LT":
        return x < value
    if mode == "LE":
        return x <= value
    if mode == "GT":
        return x > value
    if mode == "GE":
        return x >= value
    if mode == "RANGE":
        return (x >= value[0]) & (x <= value[1])
    m = np.isin(x, np.array(list(value), object))
    return ~m if mode == "NOT_IN" else m
