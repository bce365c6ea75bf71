"""Neural pileup polisher: held-out quality + CLI integration."""

import os

import numpy as np
import pytest

from ngspeciesid.models.polisher import neural_polish_round
from ngspeciesid.models.train import load_params, mutate, ACGT

MODEL = os.path.join(os.path.dirname(__file__), "..",
                     "ngspeciesid", "data", "polisher_gru.npz")

pytestmark = pytest.mark.skipif(not os.path.isfile(MODEL),
                                reason="trained polisher params not present")


def edit_distance(a, b):
    from ngspeciesid.ops.edit import _dp_rows
    return int(_dp_rows(a, b, anchored=True)[b.size])


class TestNeuralPolish:
    def test_corrects_draft_errors(self, rng):
        params = load_params(MODEL)
        t = ACGT[rng.integers(0, 4, size=400)]
        reads, quals = zip(*(mutate(rng, t, 0.08) for _ in range(30)))
        draft = t.copy()
        draft[60] = ACGT[(int(np.where(ACGT == draft[60])[0][0]) + 1) % 4]
        draft = np.delete(draft, 150)
        draft = np.insert(draft, 250, ACGT[0])
        polished = neural_polish_round(params, draft, list(reads), list(quals))
        assert edit_distance(polished, t) <= 1

    def test_heldout_templates(self, rng):
        params = load_params(MODEL)
        ok = 0
        for _ in range(5):
            t = ACGT[rng.integers(0, 4, size=350)]
            reads, quals = zip(*(mutate(rng, t, 0.10) for _ in range(25)))
            draft, _ = mutate(rng, t, 0.02)
            polished = neural_polish_round(params, draft, list(reads), list(quals))
            if edit_distance(polished, t) <= 1:
                ok += 1
        assert ok >= 4

    def test_cli_medaka_model_flag(self, tmp_path, rng):
        from ngspeciesid.cli import main
        template = "".join("ACGT"[c] for c in rng.integers(0, 4, size=300))
        fq = tmp_path / "in.fastq"
        with open(fq, "w") as f:
            for i in range(30):
                seq = "".join(ch for ch in template if rng.random() > 0.03)
                qual = "".join(chr(int(q)) for q in rng.integers(45, 63, size=len(seq)))
                f.write(f"@r{i}\n{seq}\n+\n{qual}\n")
        out = tmp_path / "o"
        rc = main(["--ont", "--fastq", str(fq), "--outfolder", str(out),
                   "--consensus", "--medaka", "--medaka_model", MODEL, "--t", "1"])
        assert rc == 0
        cons = list(out.glob("medaka_cl_id_*/consensus.fasta"))
        assert len(cons) == 1
        seq = open(cons[0]).read().splitlines()[1]
        from ngspeciesid.utils.seqs import seq_bytes
        assert edit_distance(seq_bytes(seq), seq_bytes(template)) <= 2


class TestMedakaModelSemantics:
    """--medaka_model resolution (reference consensus.py:100-101) after the
    prove-or-demote eval (scripts/eval_polisher.py)."""

    def test_empty_is_deterministic(self):
        from ngspeciesid.consensus.stage import _load_neural_polisher
        assert _load_neural_polisher("") is None

    def test_medaka_model_name_maps_to_caller(self):
        from ngspeciesid.consensus.stage import _load_neural_polisher
        assert _load_neural_polisher("r941_min_high_g360") is None
        assert _load_neural_polisher("r103_min_high_g345") is None

    def test_npz_path_loads_gru(self):
        import os
        from ngspeciesid.consensus.stage import _load_neural_polisher
        path = os.path.join(os.path.dirname(__file__), "..",
                            "ngspeciesid", "data", "polisher_gru.npz")
        got = _load_neural_polisher(path)
        assert got is not None
        params, fn = got
        assert callable(fn) and params

    def test_unknown_string_errors(self):
        from ngspeciesid.consensus.stage import _load_neural_polisher
        with pytest.raises(ValueError):
            _load_neural_polisher("definitely/not/a/model.bin")


class TestPolisherAccuracyGrid:
    def test_deterministic_caller_is_medaka_class_and_gru_not_better(self):
        # the demotion evidence, in miniature: at amplicon depth the
        # deterministic caller already reaches the template and the GRU
        # never improves on it (full grid: scripts/eval_polisher.py)
        from scripts.eval_polisher import run_grid
        import os
        from ngspeciesid.models.train import load_params
        path = os.path.join(os.path.dirname(__file__), "..",
                            "ngspeciesid", "data", "polisher_gru.npz")
        params = load_params(path)
        rows = run_grid(params, n_templates=3, tlen=400, seed=7)
        for depth, e, d1, d2, dg in rows:
            if depth >= 30 and e <= 0.10:
                assert d2 == 0.0      # medaka-class at amplicon depth
            assert dg >= d2 - 1e-9    # GRU never beats the caller
