"""Write the seeded multi-genome benchmark workload as .faa files.

A thin command line over spacedust_tpu/db/synth.py: two seeded ancestor
proteomes (~4,300 and ~1,600 genes), each evolved into N descendant
genomes (gene loss, operon-block moves and inversions, BLOSUM62-
conditional substitutions).  The default is the 12-genome, ~31.9k-gene
workload; the output is byte-identical for the same seed.

Usage: python tools/make_scale_db.py OUTDIR [n_per_ancestor] [seed]
"""

from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main() -> None:
    from spacedust_tpu.db.synth import write_genomes
    outdir = Path(sys.argv[1] if len(sys.argv) > 1 else ".tmp/scale_genomes")
    per_ancestor = int(sys.argv[2]) if len(sys.argv) > 2 else 6
    seed = int(sys.argv[3]) if len(sys.argv) > 3 else 42
    paths = write_genomes(outdir, seed, per_ancestor=per_ancestor)
    n_genes = sum(Path(p).read_text().count(">") for p in paths)
    print(f"{len(paths)} genomes, {n_genes} genes -> {outdir}")


if __name__ == "__main__":
    main()
