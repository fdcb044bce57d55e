"""The port's ``data/lm_data.py`` (a copy of the reference's, numpy only)
against the reference's: the same tokens, exactly."""
import numpy as np
import pytest

# ruff: noqa: E402
torch = pytest.importorskip("torch")

from repro.data.lm_data import LMDataConfig as JLMDataConfig
from repro.data.lm_data import SyntheticLM as JSyntheticLM
from repro_torch.data import LMDataConfig, SyntheticLM


@pytest.mark.parametrize("seed,vocab,seq,batch", [
    (0, 256, 32, 4), (1, 32000, 64, 2), (7, 1000, 17, 3), (3, 5, 9, 1),
])
def test_batches_equal_reference_exactly(seed, vocab, seq, batch):
    got = SyntheticLM(LMDataConfig(vocab, seq, batch, seed=seed))
    want = JSyntheticLM(JLMDataConfig(vocab, seq, batch, seed=seed))
    for step in (0, 1, 5, 1234):
        g, w = got.batch(step), want.batch(step)
        assert sorted(g) == sorted(w) == ["targets", "tokens"]
        for k in g:
            assert g[k].dtype == w[k].dtype == np.int32
            np.testing.assert_array_equal(g[k], w[k])
        np.testing.assert_array_equal(g["tokens"][:, 1:],
                                      g["targets"][:, :-1])


def test_iterate_resumes_at_its_cursor():
    data = SyntheticLM(LMDataConfig(100, 8, 2, seed=4))
    it = data.iterate(3)
    for step in (3, 4, 5):
        np.testing.assert_array_equal(next(it)["tokens"],
                                      data.batch(step)["tokens"])
