"""The LM data path against the reference: ``synthetic_batch`` bit-equal
for a decoder, the audio encoder (features, unshifted labels) and the VLM
(vision embeddings, mask, M-RoPE positions); the token file written and
read by both packages alike; disjoint per-host streams."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

pytestmark = pytest.mark.torch_port

DTYPES = {"tokens": torch.int32, "labels": torch.int32,
          "positions": torch.int32, "features": torch.float32,
          "vision_embeds": torch.float32, "vision_mask": torch.bool}


@pytest.mark.parametrize("arch", ["granite-3-8b", "hubert-xlarge",
                                  "qwen2-vl-2b"])
@pytest.mark.parametrize("seq", [1, 9, 33])
def test_synthetic_batch_is_the_reference_s(arch, seq):
    from repro.configs import get_smoke_config as ref_smoke
    from repro.data import synthetic_batch as ref_batch
    from repro_torch.configs import get_smoke_config
    from repro_torch.data import synthetic_batch

    for seed, step in ((0, 0), (17, 5)):
        got = synthetic_batch(get_smoke_config(arch), 3, seq, seed=seed,
                              step=step)
        want = ref_batch(ref_smoke(arch), 3, seq, seed=seed, step=step)
        assert sorted(got) == sorted(want)
        for k, v in got.items():
            assert v.device == torch.device("cpu")
            assert v.dtype == DTYPES[k], k
            np.testing.assert_array_equal(v.numpy(), np.asarray(want[k]))


def test_synthetic_batches_step_through():
    from repro_torch.configs import get_smoke_config
    from repro_torch.data import synthetic_batch, synthetic_batches

    cfg = get_smoke_config("rwkv6-1.6b")
    it = synthetic_batches(cfg, 2, 8, seed=4)
    for step in range(3):
        got = next(it)
        want = synthetic_batch(cfg, 2, 8, seed=4, step=step)
        assert torch.equal(got["tokens"], want["tokens"])


@pytest.mark.parametrize("top", [50, 70_000])  # uint16 and uint32 files
def test_token_file_read_by_both_packages(tmp_path, top):
    """A file written by either package is read back the same by both
    (same header, widths, shuffle and windows)."""
    from repro.data import TokenFileDataset as RefDataset
    from repro.data import write_token_file as ref_write
    from repro_torch.data import TokenFileDataset, write_token_file

    toks = np.arange(1000) % top + (top > 2**16) * 60_000
    paths = {w: str(tmp_path / f"{w}.bin") for w in ("port", "ref")}
    write_token_file(paths["port"], toks)
    ref_write(paths["ref"], toks)
    assert open(paths["port"], "rb").read() == open(paths["ref"], "rb").read()
    got = list(TokenFileDataset(paths["ref"], seq_len=16, batch_size=4,
                                seed=2))
    want = list(RefDataset(paths["port"], seq_len=16, batch_size=4, seed=2))
    assert len(got) == len(want) == (999 // 16) // 4
    for g, w in zip(got, want):
        for k in ("tokens", "labels"):
            assert g[k].dtype == torch.int32
            np.testing.assert_array_equal(g[k].numpy(), w[k])
        np.testing.assert_array_equal(g["labels"][:, :-1], g["tokens"][:, 1:])


def test_token_file_rejects_a_bad_magic(tmp_path):
    from repro_torch.data import TokenFileDataset

    path = tmp_path / "bad.bin"
    path.write_bytes(np.zeros(8, np.uint32).tobytes())
    with pytest.raises(ValueError, match="bad magic"):
        TokenFileDataset(str(path), seq_len=4, batch_size=1)


def test_host_streams_are_disjoint_and_the_reference_s(tmp_path):
    """Each of three hosts reads its stride of one shuffled order of
    windows: no window on two hosts, and each host's batches the
    reference's."""
    from repro.data import TokenFileDataset as RefDataset
    from repro_torch.data import TokenFileDataset, write_token_file

    path = str(tmp_path / "toks.bin")
    write_token_file(path, np.arange(10_000))  # every window distinct
    seen = []
    for host in range(3):
        kw = dict(seq_len=16, batch_size=2, host_id=host, num_hosts=3,
                  seed=3)
        got = list(TokenFileDataset(path, **kw))
        want = list(RefDataset(path, **kw))
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g["tokens"].numpy(), w["tokens"])
        seen.append({tuple(r.tolist()) for b in got for r in b["tokens"]})
    assert not (seen[0] & seen[1] or seen[0] & seen[2] or seen[1] & seen[2])
