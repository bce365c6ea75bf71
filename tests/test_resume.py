"""Content-addressed stage resume (--resume)."""

import json
import os
import shutil

import pytest

from ngspeciesid.artifacts import (
    ArtifactCache,
    file_digest,
    load_clusters,
    save_clusters,
    stage_key,
)
from ngspeciesid.cli import main as cli_main

SAMPLE = "/root/reference/test/sample_h1.fastq"


def _run(outfolder, *extra):
    rc = cli_main([
        "--ont", "--fastq", SAMPLE, "--outfolder", outfolder,
        "--t", "1", *extra,
    ])
    assert rc == 0


def _read(path):
    with open(path) as f:
        return f.read()


class TestArtifactCache:
    def test_lookup_miss_and_record(self, tmp_path):
        cache = ArtifactCache(str(tmp_path))
        assert cache.lookup("sort", "k1") is None
        art = cache.path("x.txt")
        with open(art, "w") as f:
            f.write("hello")
        cache.record("sort", "k1", [art])
        assert cache.lookup("sort", "k1") == [art]
        assert cache.lookup("sort", "k2") is None
        # fresh instance reloads the manifest
        assert ArtifactCache(str(tmp_path)).lookup("sort", "k1") == [art]

    def test_missing_file_invalidates(self, tmp_path):
        cache = ArtifactCache(str(tmp_path))
        art = cache.path("y.txt")
        with open(art, "w") as f:
            f.write("z")
        cache.record("s", "k", [art])
        os.remove(art)
        assert cache.lookup("s", "k") is None

    def test_clusters_roundtrip(self, tmp_path):
        clusters = {3: ["a_1.5", "b_0.25"], 9: ["c_2.0"]}
        p = str(tmp_path / "c.json")
        save_clusters(p, clusters)
        assert load_clusters(p) == clusters

    def test_stage_key_sensitivity(self, tmp_path):
        p = tmp_path / "in.txt"
        p.write_text("AAAA")
        d = file_digest(str(p))
        k1 = stage_key(d, {"k": 13})
        assert stage_key(d, {"k": 14}) != k1
        p.write_text("AAAT")
        assert stage_key(file_digest(str(p)), {"k": 13}) != k1


@pytest.mark.slow
class TestResumeEndToEnd:
    def test_resume_reuses_and_matches(self, tmp_path):
        out = str(tmp_path / "run")
        _run(out, "--resume")
        clusters_1 = _read(os.path.join(out, "final_clusters.tsv"))
        origins_1 = _read(os.path.join(out, "final_cluster_origins.tsv"))
        manifest = os.path.join(out, ".ngsid_cache", "manifest.json")
        with open(manifest) as f:
            m1 = json.load(f)
        assert set(m1) == {"sort", "cluster"}

        # resumed run: stage artifacts hit, outputs identical
        _run(out, "--resume")
        assert _read(os.path.join(out, "final_clusters.tsv")) == clusters_1
        assert _read(os.path.join(out, "final_cluster_origins.tsv")) == origins_1
        with open(manifest) as f:
            assert json.load(f) == m1

    def test_param_change_invalidates(self, tmp_path):
        out = str(tmp_path / "run")
        _run(out, "--resume")
        manifest = os.path.join(out, ".ngsid_cache", "manifest.json")
        with open(manifest) as f:
            key_before = json.load(f)["cluster"]["key"]
        _run(out, "--resume", "--mapped_threshold", "0.8")
        with open(manifest) as f:
            key_after = json.load(f)["cluster"]["key"]
        assert key_after != key_before

    def test_resume_output_equals_fresh(self, tmp_path):
        fresh = str(tmp_path / "fresh")
        res = str(tmp_path / "res")
        _run(fresh)
        _run(res, "--resume")
        _run(res, "--resume")  # second pass goes through the cache
        for name in ("final_clusters.tsv", "final_cluster_origins.tsv", "sorted.fastq"):
            assert _read(os.path.join(res, name)) == _read(os.path.join(fresh, name))

    def test_relative_outfolder_resume(self, tmp_path, monkeypatch):
        # regression: relative --outfolder paths must still hit the cache
        monkeypatch.chdir(tmp_path)
        _run("rel_out", "--resume")
        _run("rel_out", "--resume")
        with open(os.path.join("rel_out", ".ngsid_cache", "manifest.json")) as f:
            m = json.load(f)
        cache = ArtifactCache("rel_out")
        assert cache.lookup("sort", m["sort"]["key"]) is not None
        assert cache.lookup("cluster", m["cluster"]["key"]) is not None
