"""The generator's invariants, at a small size on the CPU."""

import numpy as np
import pytest

from gpubench.gen import synth
from gpubench.harness import load_cell
from gpubench.tests.conftest import ROOT, SMALL
from pathlib import Path


def _cell(name="tcga_cells_em", **over):
    cell = load_cell(Path(ROOT), name)
    for k, v in {**SMALL, **over}.items():
        (cell.traffic if k in cell.traffic else cell.config)[k] = v
    return cell


@pytest.fixture(scope="module")
def made():
    cell = _cell()
    ann = synth.make_annotation(cell.config, cell.traffic, "cpu")
    raw = synth.make_sample(ann, cell.config, cell.traffic, 2**31 + 11, 0,
                            "cpu")
    return cell, ann, raw


def test_same_seed_same_sample(made):
    cell, ann, raw = made
    again = synth.make_sample(ann, cell.config, cell.traffic, 2**31 + 11, 0,
                              "cpu")
    other = synth.make_sample(ann, cell.config, cell.traffic, 2**31 + 12, 0,
                              "cpu")
    for k in ("codes1", "quals1", "codes2", "sid", "pos", "ins", "offsets"):
        assert np.array_equal(getattr(raw, k), getattr(again, k)), k
    assert not np.array_equal(raw.codes1, other.codes1)
    ann2 = synth.make_annotation(cell.config, cell.traffic, "cpu")
    assert np.array_equal(ann.codes, ann2.codes)


def test_sizes(made):
    cell, ann, _ = made
    assert ann.M == cell.config["isoforms"]
    assert ann.n_genes == cell.config["genes"]
    assert ann.gene_starts[0] == 1 and ann.gene_starts[-1] == ann.M + 1
    k = np.diff(ann.gene_starts)
    assert k.min() >= 1
    assert np.all(ann.tlen == ann.u5 + ann.core[ann.iso_gene] + ann.u3)


def test_core_fragments_align_to_the_family(made):
    """Each read's alignments: one to its own isoform, or, for a fragment
    inside its gene's core, one to every isoform of the gene's paralog
    family, all at the same offset into the core, on one strand, with one
    fragment length."""
    _, ann, raw = made
    off = raw.offsets
    tl = ann.tlen
    multi = 0
    for r in range(0, raw.n1, 7):
        h = slice(off[r], off[r + 1])
        sid = raw.sid[h].astype(np.int64) - 1
        d, pos, ins = raw.dir[h], raw.pos[h], raw.ins[h]
        assert len(set(d)) == 1 and len(set(ins)) == 1
        fwd = np.where(d == 0, pos, tl[sid] - pos - ins)
        if len(sid) == 1:
            continue
        multi += 1
        g = ann.iso_gene[sid[0]]
        assert np.array_equal(sid, np.arange(ann.fam_lo[g], ann.fam_hi[g]))
        c0 = fwd - ann.u5[sid]
        assert len(set(c0)) == 1 and c0[0] >= 0
        assert c0[0] + ins[0] <= ann.core[ann.iso_gene[sid]].min()
    assert multi > 0


def test_reads_copy_their_fragment(made):
    """Mate 1 is the fragment's leading end on its strand: at its own
    alignment it matches the reference but for the error rate."""
    cell, ann, raw = made
    L = raw.codes1.shape[1]
    mism = []
    for r in range(0, raw.n1, 11):
        h = raw.offsets[r]
        s = int(raw.sid[h]) - 1
        fwd = raw.pos[h] if raw.dir[h] == 0 else \
            ann.tlen[s] - raw.pos[h] - raw.ins[h]
        a = ann.offsets[s]
        if raw.dir[h] == 0:
            want = ann.codes[a + fwd:a + fwd + L]
        else:
            end = a + fwd + raw.ins[h]
            want = (3 - ann.codes[end - L:end])[::-1]
        mism.append(np.mean(raw.codes1[r] != want))
    # paralog hits may differ by the divergence, the primary copy only by
    # the errors (the first hit is the family's first isoform, which may be
    # a paralog of the source)
    assert np.mean(mism) < cell.traffic["error_rate"] * 3 + \
        cell.traffic["paralog_divergence"]


def test_multiplicity_cap():
    cell = _cell(paralog_share=0.5, genes=40, isoforms=800)
    ann = synth.make_annotation(cell.config, cell.traffic, "cpu")
    k = np.diff(ann.gene_starts)
    assert np.max(ann.fam_hi - ann.fam_lo) <= synth.MAX_HITS
    assert k.max() <= synth.MAX_HITS // cell.traffic["paralog_family_size"]
    raw = synth.make_sample(ann, cell.config, cell.traffic, 5, 0, "cpu",
                            pairs=5000)
    assert max(raw.hist) <= synth.MAX_HITS


def test_expression_profile_is_the_traffics(made):
    """Two seeds draw different reads from one expression profile."""
    cell, ann, _ = made
    a = synth.make_sample(ann, cell.config, cell.traffic, 1, 0, "cpu")
    b = synth.make_sample(ann, cell.config, cell.traffic, 2, 0, "cpu")
    ca = np.bincount(a.sid[a.offsets[:-1]] - 1, minlength=ann.M)
    cb = np.bincount(b.sid[b.offsets[:-1]] - 1, minlength=ann.M)
    assert np.corrcoef(ca, cb)[0, 1] > 0.9
