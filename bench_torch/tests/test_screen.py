"""The configuration file picks the picture, and the desktop picture piles up.

Run on the CPU from the repository's root:

    python3 -m pytest bench_torch/tests -q

- the camera frames are byte for byte what they were before the desktop
  picture came (a sha256 of a fixed seed's pool);
- desktop frames repeat for a seed and differ for another seed or stream,
  and frame to frame;
- the desktop's capture piles into few vectorscope bins, the camera's
  does not (``skew``);
- a configuration file that the harness would not run as written (an
  unknown key or picture, an interleave the hub does not take, a wire
  format or range it does not feed) fails the schema check and the run.
"""

from __future__ import annotations

import hashlib
import json
import shutil

import pytest
import torch

from bench_torch import content, schema, screen, serve, skew, spec

torch.set_num_threads(2)

# content.frame_pool(1234, 0, 3, 72, 128, cs, "cpu"), hashed frame after frame
CAMERA_SHA256 = {
    "bt709": "de3fd22cc48891b5ae990c84525500a17a7ce6ff8bd9bdb5bf3df4898e4ec3ac",
    "bt601": "19627af00ae585e41bf9f53e10779c7f0b8bffa663507d314b2a72d328e51b9a",
}
SCREEN = "bench_torch/configs/obs_qhd60_screen_dock.json"


def _sha(pool) -> str:
    h = hashlib.sha256()
    for buf in pool:
        h.update(buf.tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("cs", sorted(CAMERA_SHA256))
def test_camera_frames_are_unchanged(cs):
    assert _sha(content.frame_pool(1234, 0, 3, 72, 128, cs, "cpu")) == CAMERA_SHA256[cs]


def test_screen_frames_repeat_for_a_seed():
    args = (2, 72, 128, "bt709", "cpu")
    a = screen.frame_pool(2**31 + 5, 0, *args)
    assert _sha(a) == _sha(screen.frame_pool(2**31 + 5, 0, *args))
    assert _sha(a) != _sha(screen.frame_pool(2**31 + 6, 0, *args))
    assert _sha(a) != _sha(screen.frame_pool(2**31 + 5, 1, *args))
    assert (a[0] != a[1]).any()
    assert a[0].shape == (72 * 3 // 2, 128) and a[0].dtype.name == "uint8"


def test_screen_piles_into_few_bins():
    dock = json.loads((spec.ROOT / SCREEN).read_text())["dock"]
    got = {}
    for kind in ("screen", "camera"):
        pool = [buf for seed in (1, 2) for buf in serve.POOLS[kind](seed, 0, 2, 360, 640, "bt709",
                                                                     "cpu")]
        got[kind] = skew.measure(pool, 360, 640, dock, "cpu")
    assert got["screen"]["top16"] >= 0.6, got
    assert got["camera"]["top16"] < 0.4, got
    assert got["screen"]["run32"] > 0.3 > got["camera"]["run32"], got


@pytest.mark.parametrize("change, says", [
    ({"colour": "bt709"}, "unknown key 'colour'"),
    ({"content": "webcam"}, "content 'webcam'"),
    ({"frame": {"format": "p010"}}, "frame.format 'p010'"),
    ({"frame": {"range": "full"}}, "frame.range 'full'"),
    ({"roi": {"interleave": 2}}, "roi.interleave 2"),
])
def test_schema_refuses_a_file_it_would_not_run(tmp_path, monkeypatch, change, says):
    bench = spec.load_benchmark()
    for c in bench["configs"]:
        (tmp_path / c["file"]).parent.mkdir(parents=True, exist_ok=True)
        shutil.copy(spec.ROOT / c["file"], tmp_path / c["file"])
    cfg = json.loads((spec.ROOT / SCREEN).read_text())
    for k, v in change.items():
        cfg[k] = {**cfg[k], **v} if isinstance(v, dict) else v
    (tmp_path / SCREEN).write_text(json.dumps(cfg))
    monkeypatch.setattr(spec, "ROOT", tmp_path)
    found = schema.problems(bench)
    assert any(p.startswith("config obs_qhd60_screen_dock: " + says) for p in found), found
    with pytest.raises(ValueError, match=says.replace("'", ".")):
        serve.Cell(cfg, {}, 1, "cpu", docks=False)


def test_schema_passes_the_files_as_they_are():
    assert schema.problems(spec.load_benchmark()) == []
