"""The port's data pipeline (``repro_torch.data``): the reference's data
tests (``tests/test_data.py``) run against the port, and ``batch_at``
bitwise the reference's for every (seed, step, dp_rank, dp_size,
num_codebooks) tried, from the synthetic corpus and from a token file."""
import numpy as np
import pytest

from repro.data import DataPipeline as RefPipeline
from repro.data import FileCorpus as RefFileCorpus
from repro.data import SyntheticCorpus as RefCorpus
from repro_torch.data import DataPipeline, FileCorpus, SyntheticCorpus


def test_determinism():
    pipe = DataPipeline(SyntheticCorpus(1000, seed=1), 32, 8)
    a = pipe.batch_at(5)
    b = pipe.batch_at(5)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])


def test_labels_are_shifted_tokens():
    pipe = DataPipeline(SyntheticCorpus(1000), 32, 4)
    b = pipe.batch_at(0)
    assert b["tokens"].shape == b["labels"].shape == (4, 32)
    np.testing.assert_array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])


def test_worker_shards_partition_global_batch():
    corpus = SyntheticCorpus(1000, seed=2)
    full = DataPipeline(corpus, 16, 8, dp_rank=0, dp_size=1).batch_at(3)
    parts = [DataPipeline(corpus, 16, 8, dp_rank=r, dp_size=4).batch_at(3)
             for r in range(4)]
    stacked = np.concatenate([p["tokens"] for p in parts], axis=0)
    np.testing.assert_array_equal(full["tokens"], stacked)


def test_resume_from_state():
    pipe = DataPipeline(SyntheticCorpus(1000), 16, 4)
    state = pipe.state_dict(7)
    assert DataPipeline.resume_step(state) == 7
    np.testing.assert_array_equal(pipe.batch_at(7)["tokens"],
                                  pipe.batch_at(7)["tokens"])


def test_bad_dp_size_rejected():
    with pytest.raises(ValueError):
        DataPipeline(SyntheticCorpus(10), 16, global_batch=6, dp_size=4)


def test_codebook_corpus_shape():
    pipe = DataPipeline(SyntheticCorpus(100, num_codebooks=4), 16, 2)
    b = pipe.batch_at(0)
    assert b["tokens"].shape == (2, 16, 4)


def _assert_batches_equal(got, want):
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == want[key].dtype
        np.testing.assert_array_equal(got[key], want[key])


@pytest.mark.parametrize("seed", [0, 3, 11])
@pytest.mark.parametrize("dp_size,codebooks", [(1, 1), (2, 1), (4, 1),
                                               (2, 4)])
def test_batch_at_bitwise_reference(seed, dp_size, codebooks):
    """Every rank's batch at several steps (0, 1, 7, 1000) and sequence
    lengths, with 1 or 4 codebooks and a vocab both above and below the
    Zipf draw's tail: bitwise the reference's."""
    for vocab, seq in ((50, 16), (32768, 257)):
        for step in (0, 1, 7, 1000):
            for rank in range(dp_size):
                kw = dict(seq_len=seq, global_batch=4, dp_rank=rank,
                          dp_size=dp_size)
                got = DataPipeline(SyntheticCorpus(vocab, seed, codebooks),
                                   **kw).batch_at(step)
                want = RefPipeline(RefCorpus(vocab, seed, codebooks),
                                   **kw).batch_at(step)
                _assert_batches_equal(got, want)


def test_iteration_and_state_match_reference():
    got = DataPipeline(SyntheticCorpus(300, seed=5), 24, 2)
    want = RefPipeline(RefCorpus(300, seed=5), 24, 2)
    for a, b, _ in zip(got, want, range(3)):
        _assert_batches_equal(a, b)
    assert got.state_dict(9) == want.state_dict(9)
    assert DataPipeline.resume_step(got.state_dict(9)) == 9


@pytest.mark.parametrize("n", [40, 1000])
def test_file_corpus_bitwise_reference(tmp_path, n):
    """A flat int32 token file (shorter and longer than a batch's span)
    read by both packages' ``FileCorpus``: the same batches."""
    path = str(tmp_path / "tokens.bin")
    np.random.default_rng(n).integers(0, 500, n).astype(np.int32) \
        .tofile(path)
    for step in (0, 1, 5, 33):
        got = DataPipeline(FileCorpus(path, 500), 16, 4).batch_at(step)
        want = RefPipeline(RefFileCorpus(path, 500), 16, 4).batch_at(step)
        _assert_batches_equal(got, want)
        assert got["tokens"].shape == (4, 16)
