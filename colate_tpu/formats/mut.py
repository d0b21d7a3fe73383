"""Columnar reader/writer for Relate ``.mut`` mutation tables.

Grammar (reference src/mutations.cpp:57-257 / Dump :286-336): one header
line, then per SNP a semicolon-separated row::

    snp;pos;dist;rs-id;tree;branch_indices(space-sep);is_not_mapping;
    is_flipped;age_begin;age_end;anc/der;[upstream;downstream;freq;...]

Unlike the reference's row-of-structs parse, this loads the whole file
into numpy columns (the downstream consumers are vectorised).
"""

from __future__ import annotations

import dataclasses
import gzip
import io

import numpy as np


@dataclasses.dataclass
class MutTable:
    """Columnar .mut file. String columns are object arrays (small files)."""

    header: str
    snp_id: np.ndarray  # int64
    pos: np.ndarray  # int64
    dist: np.ndarray  # int64
    rs_id: np.ndarray  # object
    tree: np.ndarray  # int64
    branch: list  # list[list[int]] — usually length-1
    num_branches: np.ndarray  # int64 (len of branch list)
    flipped: np.ndarray  # int64
    age_begin: np.ndarray  # float64 (f32-parsed, like the reference's stof)
    age_end: np.ndarray  # float64
    mutation_type: np.ndarray  # object, "A/C" style
    rest: np.ndarray  # object — unparsed tail (upstream;downstream;freqs)
    # precomputed allele codes (native reader): uint8 first chars + the
    # mode-mut validity mask (coal.cpp:2150-2176); None → compute from
    # mutation_type strings (pipeline.join._allele_codes)
    anc_code: np.ndarray | None = None
    der_code: np.ndarray | None = None
    allele_valid: np.ndarray | None = None

    def __len__(self) -> int:
        return int(self.pos.shape[0])

    @property
    def anc_allele(self) -> np.ndarray:
        """First character of the ancestral allele ('' if empty)."""
        return np.array(
            [t.split("/", 1)[0] if "/" in t else t for t in self.mutation_type],
            dtype=object,
        )

    @property
    def der_allele(self) -> np.ndarray:
        return np.array(
            [t.split("/", 1)[1] if "/" in t else "" for t in self.mutation_type],
            dtype=object,
        )

    @classmethod
    def read(cls, path: str, fast: bool = True) -> "MutTable":
        """Load a .mut file.

        fast=True parses via the native C++ decoder (colate_tpu.native)
        when available; the pure-Python reference-grammar parser is the
        fallback (both preserve `rest`).
        """
        if fast:
            try:
                t = cls._read_native(path)
                if t is not None:
                    return t
            except Exception:
                pass  # fall back to the reference-grammar line parser
        data = _read_text(path)
        lines = data.splitlines()
        if not lines:
            raise ValueError(f"empty .mut file: {path}")
        header = lines[0]
        rows = [ln for ln in lines[1:] if ln]
        n = len(rows)
        snp_id = np.empty(n, np.int64)
        pos = np.empty(n, np.int64)
        dist = np.empty(n, np.int64)
        rs_id = np.empty(n, object)
        tree = np.empty(n, np.int64)
        branch: list[list[int]] = []
        nbr = np.empty(n, np.int64)
        flipped = np.empty(n, np.int64)
        age_begin = np.empty(n, np.float64)
        age_end = np.empty(n, np.float64)
        mtype = np.empty(n, object)
        rest = np.empty(n, object)
        for i, ln in enumerate(rows):
            f = ln.split(";")
            snp_id[i] = int(f[0])
            pos[i] = int(f[1])
            dist[i] = int(f[2])
            rs_id[i] = f[3]
            tree[i] = int(f[4])
            br = [int(x) for x in f[5].split()] if f[5].strip() else []
            branch.append(br)
            nbr[i] = len(br)
            # f[6] = is_not_mapping (skipped by the reference parser too)
            flipped[i] = int(f[7])
            # reference parses ages with std::stof (float32): replicate
            age_begin[i] = np.float32(f[8])
            age_end[i] = np.float32(f[9])
            mtype[i] = f[10]
            rest[i] = ";".join(f[11:]) if len(f) > 11 else ""
        return cls(
            header=header,
            snp_id=snp_id,
            pos=pos,
            dist=dist,
            rs_id=rs_id,
            tree=tree,
            branch=branch,
            num_branches=nbr,
            flipped=flipped,
            age_begin=age_begin,
            age_end=age_end,
            mutation_type=mtype,
            rest=rest,
        )

    @classmethod
    def _read_native(cls, path: str) -> "MutTable | None":
        import ctypes

        from colate_tpu import native

        lib = native.load()
        if lib is None:
            return None
        err = ctypes.create_string_buffer(512)
        h = lib.cn_mut_read(path.encode(), err, 512)
        if not h:
            raise ValueError(err.value.decode() or f"native .mut parse failed: {path}")
        try:
            col = lambda c, dt: native.col_array(lib, lib.cn_mut_col, h, c, dt)
            n = int(lib.cn_mut_n(h))
            snp_id = col(0, np.int64)
            pos = col(1, np.int64)
            dist = col(2, np.int64)
            tree = col(3, np.int64)
            flipped = col(4, np.int64)
            nbr = col(5, np.int64)
            branch_flat = col(6, np.int32)
            branch_off = col(7, np.int64)
            age_begin = col(8, np.float64)
            age_end = col(9, np.float64)
            anc_code = col(10, np.uint8)
            der_code = col(11, np.uint8)
            valid = col(12, np.uint8).astype(bool)
            mtype = _LazyStrings(col(16, np.uint8), col(13, np.uint64))
            rsid = _LazyStrings(col(14, np.uint8), col(15, np.uint64))
            rest = _LazyStrings(col(17, np.uint8), col(18, np.uint64))
            nb = ctypes.c_int64()
            hp = lib.cn_mut_col(h, 19, ctypes.byref(nb))
            header = ctypes.string_at(hp, nb.value).decode() if nb.value else ""
        finally:
            lib.cn_mut_free(h)
        assert pos.shape[0] == n
        return cls(
            header=header,
            snp_id=snp_id,
            pos=pos,
            dist=dist,
            rs_id=rsid,
            tree=tree,
            branch=_FlatBranches(branch_flat, branch_off),
            num_branches=nbr,
            flipped=flipped,
            age_begin=age_begin,
            age_end=age_end,
            mutation_type=mtype,
            rest=rest,
            anc_code=anc_code,
            der_code=der_code,
            allele_valid=valid,
        )

    def write(self, path: str) -> None:
        """Dump in the reference layout (mutations.cpp:286-336)."""
        out = io.StringIO()
        header = self.header or (
            "snp;pos_of_snp;dist;rs-id;tree_index;branch_indices;is_not_mapping;"
            "is_flipped;age_begin;age_end;ancestral_allele/alternative_allele;"
            "upstream_allele;downstream_allele;"
        )
        out.write(header + "\n")
        for i in range(len(self)):
            br = " ".join(str(b) for b in self.branch[i])
            not_mapping = 1 if len(self.branch[i]) > 1 else 0
            out.write(
                f"{self.snp_id[i]};{self.pos[i]};{self.dist[i]};{self.rs_id[i]};"
                f"{self.tree[i]};{br};{not_mapping};{self.flipped[i]};"
                f"{_fmt(self.age_begin[i])};{_fmt(self.age_end[i])};"
                f"{self.mutation_type[i]};"
            )
            if self.rest[i]:
                out.write(self.rest[i])
            out.write("\n")
        opener = gzip.open if path.endswith(".gz") else open
        with opener(path, "wt") as fh:
            fh.write(out.getvalue())


class _LazyStrings:
    """List-like view over a native char blob + offsets, decoded lazily."""

    def __init__(self, blob: np.ndarray, off: np.ndarray):
        self._b = blob.tobytes()
        self._off = off

    def __len__(self) -> int:
        return int(self._off.shape[0]) - 1

    def __getitem__(self, i):
        if isinstance(i, (int, np.integer)):
            return self._b[self._off[i] : self._off[i + 1]].decode()
        # fancy/slice indexing: materialise the selection as object array
        idx = np.arange(len(self))[i]
        return np.array([self[int(j)] for j in idx], dtype=object)

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def materialize(self) -> np.ndarray:
        return np.array([s for s in self], dtype=object)


class _FlatBranches:
    """List-like view over flattened branch ids + offsets."""

    def __init__(self, flat: np.ndarray, off: np.ndarray):
        self._f = flat
        self._off = off

    def __len__(self) -> int:
        return int(self._off.shape[0]) - 1

    def __getitem__(self, i):
        return self._f[self._off[i] : self._off[i + 1]].tolist()

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]


def annotate_ages(mut: MutTable, anc) -> None:
    """Annotate age_begin/age_end from the genealogy — the equivalent of
    ``Mutations::GetAge`` (src/mutations.cpp:28-54).

    For every row mapping to exactly one branch: age_begin is the node's
    age measured by descending *left* children summing branch lengths
    (``ReadTree`` assigns child_left to the lowest-numbered child,
    src/anc.cpp:6-47), and age_end = age_begin + the node's own branch
    length.  Rows with 0 or >1 branches are left untouched.  In-place.
    """
    T, M = anc.parent.shape
    rows_t = np.arange(T)
    # child_left[p] = lowest-numbered child of p (descending loop: the
    # final write per parent is its lowest child)
    child_left = np.full((T, M), -1, np.int64)
    for j in range(M - 1, -1, -1):
        p = anc.parent[:, j].astype(np.int64)
        v = p >= 0
        child_left[rows_t[v], p[v]] = j
    leftsum = np.zeros((T, M), np.float64)
    ordered = bool(np.all((anc.parent > np.arange(M)[None, :]) | (anc.parent < 0)))
    if ordered:
        # children numbered below parents: one ascending pass
        for j in range(anc.n_hap, M):
            cl = child_left[:, j]
            leftsum[:, j] = leftsum[rows_t, cl] + anc.branch_length[rows_t, cl]
    else:
        for t in range(T):
            for j in range(M):
                s, c = 0.0, int(child_left[t, j])
                while c >= 0:
                    s += float(anc.branch_length[t, c])
                    c = int(child_left[t, c])
                leftsum[t, j] = s
    for i in range(len(mut)):
        br = mut.branch[i]
        if len(br) == 1:
            t = int(mut.tree[i])
            b = int(br[0])
            ab = leftsum[t, b]
            mut.age_begin[i] = ab
            mut.age_end[i] = ab + float(anc.branch_length[t, b])


def _fmt(x: float) -> str:
    """C++ default ostream formatting (6 significant digits)."""
    return f"{x:g}"


def _read_text(path: str) -> str:
    """Read path, falling back to path.gz like the reference (mutations.cpp:263-266)."""
    import os

    if not os.path.exists(path) and os.path.exists(path + ".gz"):
        path = path + ".gz"
    try:
        with gzip.open(path, "rt") as fh:
            return fh.read()
    except (OSError, gzip.BadGzipFile):
        with open(path, "rt") as fh:
            return fh.read()
