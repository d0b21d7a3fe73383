"""Large-BAM streaming benchmark: ours vs the reference's htslib path.

Generates a synthetic coordinate-sorted BAM of N uniform reads (length
60, slices of the reference genome, all passing filters) plus the
matching ref genome and .mut table, then runs `make_tmp --target_bam`
through our CLI (native streaming pileup, native/hts.cpp) and through
the reference binary, measuring wall-clock and peak RSS via os.wait4.

Usage: python tools/bench_bam_stream.py [n_reads] [--keep]
  n_reads default 1,000,000 (~190 MB decompressed, ~90 MB BGZF).
  11M reads ≈ a 2 GB decompressed whole-genome-scale BAM.

Prints one JSON line with both measurements.
"""

from __future__ import annotations

import json
import os
import resource
import struct
import subprocess
import sys
import time
import zlib

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests"))

RLEN = 60
_NT16_CODE = {c: i for i, c in enumerate("=ACMGRSVTWYHKDBN")}


def gen_bam(path: str, ref: np.ndarray, n_reads: int, contig: str) -> None:
    """Vectorised BAM writer: n_reads uniform 60bp reads, sorted.
    Streams in 1M-read chunks so generation memory stays bounded."""
    L = ref.shape[0]
    g = np.random.default_rng(7)
    all_pos = np.sort(g.integers(3, L - RLEN - 3, n_reads)).astype(np.int32)

    name = b"r\x00"
    body_len = 32 + len(name) + 4 + (RLEN + 1) // 2 + RLEN
    rec_len = 4 + body_len

    code_map = np.zeros(256, np.uint8)
    for c, v in _NT16_CODE.items():
        code_map[ord(c)] = v

    def bgzf_write(fh, data: bytes) -> None:
        for i in range(0, len(data), 60000):
            block = data[i : i + 60000]
            co = zlib.compressobj(1, zlib.DEFLATED, -15)
            comp = co.compress(block) + co.flush()
            fh.write(
                struct.pack(
                    "<BBBBIBBHBBHH",
                    0x1F, 0x8B, 8, 4, 0, 0, 0xFF, 6, 66, 67, 2,
                    len(comp) + 25,
                )
            )
            fh.write(comp)
            fh.write(
                struct.pack("<II", zlib.crc32(block) & 0xFFFFFFFF, len(block))
            )

    text = f"@HD\tVN:1.6\tSO:coordinate\n@SQ\tSN:{contig}\tLN:{L}\n"
    header = bytearray()
    header += b"BAM\x01"
    header += struct.pack("<i", len(text)) + text.encode()
    header += struct.pack("<i", 1)
    header += struct.pack("<i", len(contig) + 1) + contig.encode() + b"\x00"
    header += struct.pack("<i", L)

    with open(path, "wb") as fh:
        bgzf_write(fh, bytes(header))
        CH = 1_000_000
        for lo in range(0, n_reads, CH):
            pos = all_pos[lo : lo + CH]
            bgzf_write(fh, _records_chunk(pos, ref, code_map, name, body_len,
                                          rec_len).tobytes())
        fh.write(
            bytes.fromhex(
                "1f8b08040000000000ff0600424302001b0003000000000000000000"
            )
        )


def _records_chunk(pos, ref, code_map, name, body_len, rec_len) -> np.ndarray:
    n_reads = pos.shape[0]

    # fixed header fields for every record
    head = np.zeros((n_reads, 36), np.uint8)
    head[:, 0:4] = np.frombuffer(struct.pack("<i", body_len), np.uint8)
    # refID=0
    head[:, 8:12] = pos.view(np.uint8).reshape(n_reads, 4)
    head[:, 12] = len(name)  # l_read_name
    head[:, 13] = 60  # mapq
    head[:, 16] = 1  # n_cigar lo
    # flag=0 (bytes 18-19), l_seq at 20-23
    head[:, 20:24] = np.frombuffer(struct.pack("<i", RLEN), np.uint8)
    head[:, 24:28] = np.frombuffer(struct.pack("<i", -1), np.uint8)  # next_refID
    head[:, 28:32] = np.frombuffer(struct.pack("<i", -1), np.uint8)  # next_pos
    # tlen=0 at 32-35

    cigar = np.frombuffer(struct.pack("<I", (RLEN << 4) | 0), np.uint8)

    # per-read packed sequence: nibble codes of ref[pos:pos+60]
    idx = pos[:, None].astype(np.int64) + np.arange(RLEN)[None, :]
    codes = code_map[ref[idx]]  # [n, 60]
    packed = (codes[:, 0::2] << 4) | codes[:, 1::2]  # [n, 30]

    rec = np.zeros((n_reads, rec_len), np.uint8)
    rec[:, :36] = head
    rec[:, 36 : 36 + len(name)] = np.frombuffer(name, np.uint8)
    o = 36 + len(name)
    rec[:, o : o + 4] = cigar
    rec[:, o + 4 : o + 4 + 30] = packed
    rec[:, o + 34 :] = 37  # qual
    return rec


def run_timed(cmd: list[str], env=None) -> tuple[float, float, int]:
    """(wall_s, max_rss_mb, rc) of a subprocess via os.wait4."""
    t0 = time.time()
    p = subprocess.Popen(
        cmd, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL, env=env
    )
    _, status, ru = os.wait4(p.pid, 0)
    wall = time.time() - t0
    return wall, ru.ru_maxrss / 1000.0, os.waitstatus_to_exitcode(status)


def main() -> None:
    n_reads = int(sys.argv[1]) if len(sys.argv) > 1 else 1_000_000
    d = "/tmp/colate_bam_bench"
    os.makedirs(d, exist_ok=True)
    contig = "1"
    L = max(10_000_000, n_reads * 9)
    bam = os.path.join(d, f"big_{n_reads}.bam")

    from colate_tpu.formats.fasta import write_fasta
    from helpers.synth import make_mut

    rgp = os.path.join(d, f"rg{L}_chr1.fa")
    if not os.path.exists(rgp):
        g = np.random.default_rng(1)
        ref = g.choice(np.frombuffer(b"ACGT", np.uint8), L)
        write_fasta(rgp, contig, ref.tobytes().decode())
        np.save(rgp + ".npy", ref)
    else:
        ref = np.load(rgp + ".npy")
    rg_prefix = rgp[: -len("_chr1.fa")]

    mutp = os.path.join(d, f"mut{L}_chr1.mut")
    if not os.path.exists(mutp):
        make_mut(mutp, 200_000, seed=3, chrom_span=L - 10)
    mut_prefix = mutp[: -len("_chr1.mut")]

    if not os.path.exists(bam):
        t0 = time.time()
        if "--gen" in sys.argv:
            gen_bam(bam, ref, n_reads, contig)
        else:
            # generate in a subprocess: the multi-GB generation arrays
            # would otherwise pollute the rusage of the measured children
            subprocess.run(
                [sys.executable, os.path.abspath(__file__), str(n_reads), "--gen"],
                check=True, stdout=subprocess.DEVNULL,
            )
        print(f"generated {bam} in {time.time()-t0:.1f}s", file=sys.stderr)
    if "--gen" in sys.argv:
        return
    dec_mb = n_reads * (4 + 32 + 2 + 4 + 30 + RLEN) / 1e6
    print(
        f"BAM: {os.path.getsize(bam)/1e6:.0f} MB compressed, "
        f"{dec_mb:.0f} MB decompressed, {n_reads} reads",
        file=sys.stderr,
    )

    chrf = os.path.join(d, "chr.txt")
    with open(chrf, "w") as fh:
        fh.write("1\n")

    base = [
        "--mode", "make_tmp", "--mut", mut_prefix, "--target_bam", bam,
        "--ref_genome", rg_prefix, "--chr", chrf,
    ]
    env = {**os.environ, "PYTHONPATH": REPO}
    ours_w, ours_rss, rc = run_timed(
        [sys.executable, "-m", "colate_tpu", *base, "-o", os.path.join(d, "ours")],
        env=env,
    )
    assert rc == 0, "our make_tmp failed"

    ref_bin = "/tmp/refbin/Colate"
    if os.path.exists(ref_bin):
        ref_w, ref_rss, rc = run_timed(
            [ref_bin, *base, "-o", os.path.join(d, "refout")]
        )
        assert rc == 0, "reference make_tmp failed"
        same = open(os.path.join(d, "ours.colate.in"), "rb").read() == open(
            os.path.join(d, "refout.colate.in"), "rb"
        ).read()
    else:
        ref_w = ref_rss = None
        same = None

    print(
        json.dumps(
            {
                "metric": "bam_make_tmp",
                "n_reads": n_reads,
                "bam_decompressed_mb": round(dec_mb),
                "ours_wall_s": round(ours_w, 2),
                "ours_max_rss_mb": round(ours_rss, 1),
                "ours_mb_per_s": round(dec_mb / ours_w, 1),
                "reference_wall_s": None if ref_w is None else round(ref_w, 2),
                "reference_max_rss_mb": None if ref_rss is None else round(ref_rss, 1),
                "reference_mb_per_s": None if ref_w is None else round(dec_mb / ref_w, 1),
                "output_byte_identical": same,
            }
        )
    )


if __name__ == "__main__":
    main()
