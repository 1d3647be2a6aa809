"""The port's io/fs directory copies: a local tree uploaded with upload_dir
and downloaded back with download_dir keeps every file, dot-files and
nested directories included, through an in-memory store and through a
directory-backed one."""
import os

import pytest

from gdmix_tpu_torch.io import fs

TREE = {"model.bin": b"weights", ".metadata": b"hidden",
        "sub/.keep": b"", "sub/deeper/part-00000.avro": b"avro"}


def _write_tree(root):
    for rel, data in TREE.items():
        path = os.path.join(root, *rel.split("/"))
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "wb") as f:
            f.write(data)


def _read_tree(root):
    out = {}
    for d, _, files in os.walk(root):
        for name in files:
            path = os.path.join(d, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root).replace(os.sep, "/")] = f.read()
    return out


@pytest.mark.parametrize("scheme", ["mem", "fakefs"])
def test_upload_download_round_trip_keeps_dot_files(tmp_path, monkeypatch,
                                                    scheme):
    src, back = str(tmp_path / "src"), str(tmp_path / "back")
    _write_tree(src)
    monkeypatch.setenv("GDMIX_FAKEFS_ROOT", str(tmp_path / "store"))
    mid = f"{scheme}://round-trip-{os.getpid()}/{tmp_path.name}"
    fs.upload_dir(src, mid)
    fs.download_dir(mid + "/", back)
    assert _read_tree(back) == TREE


def test_find_files_still_skips_dot_files(tmp_path):
    _write_tree(str(tmp_path))
    got = [os.path.relpath(f, tmp_path).replace(os.sep, "/")
           for f in fs.find_files(str(tmp_path))]
    assert got == ["model.bin", "sub/deeper/part-00000.avro"]
