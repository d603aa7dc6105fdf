"""The seeded genome generator (spacedust_tpu/db/synth.py): the same seed
gives the same bytes, the sizes come out as asked, and a small generated
pair carries conserved gene clusters that clustersearch finds."""

import hashlib

import numpy as np
import pytest

from spacedust_tpu.db import synth


def _digest(texts):
    return hashlib.sha1("".join(a + t for a, t in texts).encode()).hexdigest()


def test_same_seed_same_bytes_other_seed_other_bytes():
    a = synth.genome_texts(7, ancestors=(120, 60), per_ancestor=2)
    b = synth.genome_texts(7, ancestors=(120, 60), per_ancestor=2)
    c = synth.genome_texts(8, ancestors=(120, 60), per_ancestor=2)
    assert _digest(a) == _digest(b)
    assert _digest(a) != _digest(c)


def test_sizes_follow_the_request():
    texts = synth.genome_texts(3, ancestors=(400, 200), per_ancestor=3)
    assert [acc for acc, _ in texts] == [
        "SYNA000.1", "SYNA001.1", "SYNA002.1",
        "SYNB000.1", "SYNB001.1", "SYNB002.1"]
    genes = [t.count(">") for _, t in texts]
    # each gene is kept with probability KEEP_P
    for n, anc in zip(genes, [400] * 3 + [200] * 3):
        assert abs(n - synth.KEEP_P * anc) < 5 * np.sqrt(anc)


def test_length_distribution_and_long_tail():
    rng = np.random.default_rng(0)
    lens = synth.protein_lengths(200_000, rng)
    assert lens.min() >= synth.LEN_MIN
    assert abs(np.median(lens) - 280) < 5
    assert abs(lens.mean() - 315) < 5
    assert ((lens >= 2000) & (lens <= 4000)).mean() > 0.0005


def test_full_workload_shape():
    """The 12-genome default: ~31.9k genes and ~10 M residues, the shape
    of a deployment that clusters a dozen bacterial genomes."""
    texts = synth.genome_texts(42)
    assert len(texts) == 12
    n_genes = sum(t.count(">") for _, t in texts)
    residues = sum(len(ln) for _, t in texts for ln in t.splitlines()
                   if not ln.startswith(">"))
    assert 31_000 < n_genes < 33_000
    assert 9.5e6 < residues < 11.5e6


def test_headers_parse_as_prodigal(tmp_path):
    db = synth.make_setdb(tmp_path, 1, ancestors=(30,), per_ancestor=2)
    assert db.num_sets == 2
    assert db.size == sum(1 for n in db.names)
    assert all(n.startswith(("SYNA000.1_", "SYNA001.1_")) for n in db.names)
    assert db.seq_data.max() < 20           # canonical residues only


@pytest.mark.parametrize("seed", [11])
def test_clustersearch_finds_conserved_blocks(tmp_path, seed):
    """Two descendants of one small ancestor share most genes in
    operon-sized blocks; clustersearch reports clusters of those blocks
    spanning both genomes."""
    from spacedust_tpu.workflow.clustersearch import (ClusterSearchParams,
                                                      cluster_search)
    db = synth.make_setdb(tmp_path, seed, ancestors=(60,), per_ancestor=2)
    res = cluster_search(db, db, ClusterSearchParams(filter_self_match=True))
    hits = [ln for ln in res.tsv.splitlines() if ln.startswith(">")]
    assert len(res.clusters) >= 1
    assert len(hits) >= 10
    # hits pair genes of the two different genomes
    assert any("SYNA000.1" in ln and "SYNA001.1" in ln
               for ln in res.tsv.splitlines() if ln.startswith("#"))
