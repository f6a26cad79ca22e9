"""The port's backward-hook readiness dry-run against the JAX package's:
``readiness_report`` equal, key for key, for all 11 archs at a reduced
depth (4 layers; the vlm and hybrid families at their smallest whole
group) and for the two anchors at full depth (kimi-k2-1t-a32b: 62059
buckets, 63 segments; starcoder2-15b: 1312 and 42); and the CLI."""

import pytest

torch = pytest.importorskip("torch")

from repro.launch.hook_dryrun import readiness_report as j_report  # noqa: E402
from repro_torch import configs as C  # noqa: E402
from repro_torch.launch import hook_dryrun as H  # noqa: E402

ANCHORS = {"kimi-k2-1t-a32b": (62059, 63), "starcoder2-15b": (1312, 42)}


def _depth(arch) -> int:
    cfg = C.get_config(arch)
    if cfg.family == "vlm":
        return cfg.cross_attn_every
    if cfg.family == "hybrid":
        return cfg.attn_every
    return 4


@pytest.mark.parametrize("arch", C.list_archs())
def test_report_equals_reference_at_reduced_depth(arch):
    n = _depth(arch)
    got = H.readiness_report(arch, n_layers=n)
    assert got == j_report(arch, n_layers=n)
    assert got["n_layers"] == n


@pytest.mark.parametrize("arch", list(ANCHORS))
def test_anchor_reports_equal_reference_at_full_depth(arch):
    got = H.readiness_report(arch)
    assert got == j_report(arch)
    assert (got["n_buckets"], got["n_segments"]) == ANCHORS[arch]
    assert got["first_ready_segment"] < got["n_segments"] - 1


def test_bucket_options_pass_through():
    kw = dict(bucket_bytes=16 << 20, max_chunk_bytes=1 << 16, n_ranks=4,
              n_layers=2)
    assert H.readiness_report("yi-6b", **kw) == j_report("yi-6b", **kw)


def test_cli_prints_one_block_per_arch(capsys):
    assert H.main(["--arch", "gpt2-124m", "--arch", "yi-6b"]) == 0
    out = capsys.readouterr().out
    assert out.count("## ") == 2 and "gpt2-124m" in out and "yi-6b" in out
    assert H.format_report(H.readiness_report("gpt2-124m")) in out
