"""Seeded synthetic bacterial genomes: the workloads the repository runs.

No real proteome ships with the repository, so benchmarks, the chip
smoke run and the end-to-end tests generate their genomes here, from a
seed, byte-identically on every machine.

  * Ancestors: proteomes whose residues are drawn from the BLOSUM62
    background and whose protein lengths follow a log-normal fitted to
    bacterial proteomes (median ~280 aa, mean ~315 aa, 30 aa minimum),
    plus a thin tail of long proteins (2,000-4,000 aa) so the long SW
    rungs are exercised.  The default pair has ~4,300 and ~1,600 genes,
    the sizes of E. coli K-12 and H. pylori 26695.  A fraction of the
    second ancestor's genes descends, in operon-sized runs, from the
    first's at high divergence, which gives cross-lineage hits of
    intermediate score and conserved neighbourhoods between lineages.
  * Descendants (`evolve_genome`): each gene kept with probability
    KEEP_P; the genome cut into operon-scale blocks (5-20 genes), a
    fraction of which are relocated and some inverted; per-residue
    substitutions at SUB_RATE drawn from the BLOSUM62 conditional
    P(b | a).

Output is Prodigal-style .faa text (">{acc}_{n} # start # end # strand #
attrs"), the header form createsetdb parses.  Random streams are keyed
with zlib.crc32, never hash(): str hashing is salted per process, which
would make every regeneration a different workload.
"""

from __future__ import annotations

import zlib
from pathlib import Path

import numpy as np

AA = "ACDEFGHIKLMNPQRSTVWY"
_AA_BYTES = np.frombuffer(AA.encode(), dtype=np.uint8)

KEEP_P = 0.9
SUB_RATE = 0.12
MOVE_FRAC = 0.25          # fraction of blocks relocated
INVERT_P = 0.4            # probability a moved block is strand-inverted

LEN_MEDIAN = 280.0
LEN_SIGMA = 0.485         # exp(sigma^2 / 2) = 315 / 280
LEN_MIN = 30
LONG_P = 0.001            # share of proteins in the long tail
LONG_RANGE = (2000, 4000)
SHARED_FRAC = 0.15        # second ancestor's genes derived from the first
SHARED_SUB_RATE = 0.45    # divergence of those derived genes

FULL = {"ancestors": (4300, 1600), "per_ancestor": 6}   # 12 genomes
SMALL = {"ancestors": (660,), "per_ancestor": 2}        # 2 genomes


def _tables() -> tuple[np.ndarray, np.ndarray]:
    """Background residue distribution and cumulative conditional
    P(b | a) over the 20 canonical residues, from the BLOSUM62 joint."""
    from ..stats.submat import load_substitution_matrix
    joint = load_substitution_matrix().prob[:20, :20].astype(np.float64)
    back = joint.sum(axis=1)
    back /= back.sum()
    cond = joint / joint.sum(axis=1, keepdims=True)
    return back, np.cumsum(cond, axis=1)


def _rng(seed: int, tag: str, index: int) -> np.random.Generator:
    return np.random.default_rng(
        [seed, zlib.crc32(tag.encode()) & 0xFFFF, index])


def protein_lengths(n: int, rng: np.random.Generator) -> np.ndarray:
    body = rng.lognormal(np.log(LEN_MEDIAN), LEN_SIGMA, n)
    lens = np.maximum(np.rint(body), LEN_MIN).astype(np.int64)
    long = rng.random(n) < LONG_P
    lo, hi = np.log(LONG_RANGE[0]), np.log(LONG_RANGE[1])
    lens[long] = np.rint(np.exp(rng.uniform(lo, hi, int(long.sum()))))
    return lens


def mutate(seq: np.ndarray, rate: float, rng: np.random.Generator,
           cum: np.ndarray) -> np.ndarray:
    """Substitute each residue with probability `rate`, the new residue
    drawn from the BLOSUM62 conditional of the old one."""
    out = seq.copy()
    pos = np.nonzero(rng.random(len(seq)) < rate)[0]
    u = rng.random(len(pos))
    new = (u[:, None] > cum[seq[pos]]).sum(axis=1)
    out[pos] = np.minimum(new, 19).astype(np.uint8)
    return out


def make_ancestors(seed: int, sizes=FULL["ancestors"]
                   ) -> list[list[tuple[int, np.ndarray]]]:
    """Ancestor proteomes as lists of (strand, residue indices)."""
    back, cum = _tables()
    ancestors: list[list[tuple[int, np.ndarray]]] = []
    for a, n in enumerate(sizes):
        rng = _rng(seed, f"ancestor{a}", 0)
        lens = protein_lengths(n, rng)
        genes = [(int(rng.choice((-1, 1))),
                  rng.choice(20, size=int(ln), p=back).astype(np.uint8))
                 for ln in lens]
        if a > 0:
            # operon-sized runs of the first ancestor's genes, diverged
            first = ancestors[0]
            n_shared = int(round(SHARED_FRAC * n))
            i = 0
            while n_shared > 0 and i < n:
                run = min(int(rng.integers(3, 11)), n_shared, n - i)
                src = int(rng.integers(0, len(first) - run + 1))
                for k in range(run):
                    strand, seq = first[src + k]
                    genes[i + k] = (strand, mutate(seq, SHARED_SUB_RATE,
                                                   rng, cum))
                n_shared -= run
                i += run + int(rng.integers(5, 30))
        ancestors.append(genes)
    return ancestors


def evolve_genome(genes: list[tuple[int, np.ndarray]], acc: str,
                  rng: np.random.Generator, cum: np.ndarray) -> str:
    """One descendant genome of an ancestor, as .faa text."""
    kept = [g for g in genes if rng.random() < KEEP_P]
    blocks = []
    i = 0
    while i < len(kept):
        w = int(rng.integers(5, 21))
        blocks.append(kept[i:i + w])
        i += w
    order = list(range(len(blocks)))
    n_move = int(len(blocks) * MOVE_FRAC)
    moved = rng.choice(len(blocks), size=n_move, replace=False)
    inverted = set()
    for b in moved:
        order.remove(b)
        order.insert(int(rng.integers(0, len(order) + 1)), b)
        if rng.random() < INVERT_P:
            inverted.add(b)
    out = []
    gi = 0
    pos = 1
    for b in order:
        blk = blocks[b]
        if b in inverted:
            blk = blk[::-1]
        for strand, seq in blk:
            gi += 1
            if b in inverted:
                strand = -strand
            start, end = pos, pos + 3 * len(seq) - 1
            pos = end + 50
            text = _AA_BYTES[mutate(seq, SUB_RATE, rng, cum)].tobytes()
            out.append(f">{acc}_{gi} # {start} # {end} # {strand} # "
                       f"ID={gi};synthetic=1")
            out.extend(text[j:j + 60].decode()
                       for j in range(0, len(text), 60))
    return "\n".join(out) + "\n"


def genome_texts(seed: int = 42, ancestors=FULL["ancestors"],
                 per_ancestor: int = FULL["per_ancestor"]
                 ) -> list[tuple[str, str]]:
    """(accession, .faa text) for every genome of the workload."""
    _, cum = _tables()
    out = []
    for a, genes in enumerate(make_ancestors(seed, ancestors)):
        tag = f"SYN{chr(ord('A') + a)}"
        for g in range(per_ancestor):
            acc = f"{tag}{g:03d}.1"
            out.append((acc, evolve_genome(genes, acc, _rng(seed, tag, g),
                                           cum)))
    return out


def write_genomes(outdir: str | Path, seed: int = 42,
                  ancestors=FULL["ancestors"],
                  per_ancestor: int = FULL["per_ancestor"]) -> list[str]:
    """Write one .faa per genome under `outdir`; returns the paths."""
    outdir = Path(outdir)
    outdir.mkdir(parents=True, exist_ok=True)
    paths = []
    for acc, text in genome_texts(seed, ancestors, per_ancestor):
        p = outdir / f"{acc}.faa"
        p.write_text(text)
        paths.append(str(p))
    return paths


def make_setdb(outdir: str | Path, seed: int = 42,
               ancestors=FULL["ancestors"],
               per_ancestor: int = FULL["per_ancestor"]):
    """Generate the genomes and ingest them with createsetdb."""
    from .fasta import create_setdb_from_fastas
    return create_setdb_from_fastas(
        write_genomes(outdir, seed, ancestors, per_ancestor))
