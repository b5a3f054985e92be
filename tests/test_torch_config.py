"""The port's config front end against the JAX package's: the yaml reader against PyYAML on
every shipped config, ``parse_config`` of the two lego-proxy NeRF configs (with and without
command-line overrides) against JAX's, field by field over the fields both configs have, and
the refusals: a setting the port has not ported raises, naming its ROADMAP item."""

import pathlib

import pytest

import test_torch_helpers  # noqa: F401  (caps torch's threads)

from app.nerf.main_nerf import NeRFAppConfig as JNeRFAppConfig
from wisp_tpu.config.utils import config_to_dict as jconfig_to_dict
from wisp_tpu.config.utils import parse_config as jparse_config

from wisp_tpu_torch.app.nerf import main_nerf
from wisp_tpu_torch.app.nerf.main_nerf import NeRFAppConfig
from wisp_tpu_torch.config import yaml_subset
from wisp_tpu_torch.config.utils import (DROPPED_KEYS, NOT_PORTED, config_to_dict,
                                         parse_config)

yaml = pytest.importorskip("yaml")

ROOT = pathlib.Path(__file__).resolve().parents[1]
CONFIGS = sorted(ROOT.glob("app/*/configs/*.yaml"))
OCTREE = str(ROOT / "app/nerf/configs/nerf_octree_lego_proxy.yaml")
HASH = str(ROOT / "app/nerf/configs/nerf_hash_lego_proxy.yaml")
# the fields whose values differ by design: the default device ('tpu' / 'cuda')
DIFFERENT_BY_DESIGN = {"device"}
OVERRIDES = ["--dataset.num-views", "4", "--trainer.save-every", "-1",
             "--trainer.render_every", "-1", "--tracer.num-steps", "32",
             "--trainer.optimizer.lr", "0.002", "--trainer.grid-lr-weight", "50",
             "--grid.feature-dim", "8", "--blas-level", "6", "--trainer.scheduler", "false",
             "--tracer.bg-color", "0.0,0.5,1.0", "--dataset-transform.num-samples", "2048"]


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: p.name)
def test_yaml_reader_matches_pyyaml(path):
    text = path.read_text()
    data = yaml_subset.loads(text)
    assert data == yaml.safe_load(text)
    written = yaml_subset.dumps(data)
    assert yaml_subset.loads(written) == data == yaml.safe_load(written)


def _shared(a, b, path=""):
    """(number of leaf fields compared, mismatches) over the keys both dicts have."""
    count, bad = 0, []
    for key in sorted(set(a) & set(b)):
        if path == "" and key in DIFFERENT_BY_DESIGN:
            continue
        va, vb = a[key], b[key]
        if isinstance(va, dict) and isinstance(vb, dict):
            c, m = _shared(va, vb, f"{path}{key}.")
            count, bad = count + c, bad + m
        else:
            count += 1
            if va != vb:
                bad.append((f"{path}{key}", va, vb))
    return count, bad


def _leaf_count(d):
    return sum(_leaf_count(v) if isinstance(v, dict) else 1 for v in d.values())


@pytest.mark.parametrize("config", [OCTREE, HASH], ids=["octree", "hash"])
@pytest.mark.parametrize("overrides", [False, True], ids=["yaml", "yaml+cli"])
def test_parse_config_matches_jax(config, overrides):
    args = ["--config", config] + (OVERRIDES if overrides else [])
    want = jconfig_to_dict(jparse_config(JNeRFAppConfig, args=args))
    got = config_to_dict(parse_config(NeRFAppConfig, args=args))
    count, bad = _shared(got, want)
    assert not bad, bad
    assert count == _leaf_count(got) - len(DIFFERENT_BY_DESIGN)  # every field of the port's
    assert got["grid"]["constructor"] == want["grid"]["constructor"]
    assert got["trainer"]["optimizer"]["constructor"] == \
        want["trainer"]["optimizer"]["constructor"]
    if overrides:
        assert got["tracer"]["num_steps"] == 32 and got["trainer"]["optimizer"]["lr"] == 0.002
        assert got["tracer"]["bg_color"] == [0.0, 0.5, 1.0]
    # the yaml keys the port does not hold are those it drops on purpose, or a setting
    # whose value is what the port does (stoch_grad: false)
    raw = yaml.safe_load(pathlib.Path(config).read_text())
    missing = [k for s, v in raw.items() if isinstance(v, dict) for k in v
               if k != "constructor" and k not in got[s]]
    assert all(k in DROPPED_KEYS or k in NOT_PORTED for k in missing), missing


def test_print_config_reads_back(tmp_path, capsys):
    cfg = parse_config(NeRFAppConfig, args=["--config", OCTREE] + OVERRIDES)
    main_nerf.print_config(cfg)
    path = tmp_path / "printed.yaml"
    path.write_text(capsys.readouterr().out)
    again = parse_config(NeRFAppConfig, args=["--config", str(path)])
    assert config_to_dict(again) == config_to_dict(cfg)


@pytest.mark.parametrize("args,match", [
    (["--config", str(ROOT / "app/nerf/configs/nerf_hash_lego_proxy_stoch.yaml")],
     "stoch_grad.*K1 stoch"),
    (["--config", HASH, "--grid.stoch-grad", "true"], "stoch_grad.*K1 stoch"),
    (["--config", OCTREE, "--tracer.raymarch-type", "uniform"], "K8"),
    (["--config", OCTREE, "--tracer.early-stop", "0.01"], "early_stop"),
    (["--config", HASH, "--tracer.seg-early-stop", "0.01"], "K6"),
    (["--config", str(ROOT / "app/nerf/configs/nerf_triplanar_lego_proxy.yaml")],
     "TriplanarGrid.*item 8"),
    (["--config", OCTREE, "--dataset.constructor", "RTMVDataset"], "RTMVDataset"),
    (["--config", OCTREE, "--tracker.wandb", "true"], "wandb"),
    (["--config", OCTREE, "--trainer.checkpoint-every", "5"], "checkpoints"),
    (["--config", OCTREE, "--trainer.random-lod", "true"], "random_lod"),
    (["--config", OCTREE, "--pretrained", "model.pth"], "pretrained"),
])
def test_unported_settings_raise(args, match):
    with pytest.raises(NotImplementedError, match=match):
        parse_config(NeRFAppConfig, args=args)


def test_unknown_and_dropped_keys(tmp_path):
    text = pathlib.Path(OCTREE).read_text().replace("  num_lods: 4\n",
                                                    "  num_lods: 4\n  dense_lod_matmul: 'bf16'\n")
    path = tmp_path / "dropped.yaml"
    path.write_text(text)
    cfg = parse_config(NeRFAppConfig, args=["--config", str(path)])
    assert "dense_lod_matmul" not in config_to_dict(cfg)["grid"]
    with pytest.raises(ValueError, match="no such setting"):
        parse_config(NeRFAppConfig, args=["--config", OCTREE, "--grid.colour", "3"])
    path.write_text(text.replace("  num_lods: 4\n", "  num_lod: 4\n"))
    with pytest.raises(ValueError, match="num_lod"):
        parse_config(NeRFAppConfig, args=["--config", str(path)])
    # a JAX setting the port neither reads nor drops is an error, not silently ignored
    with pytest.raises(ValueError, match="valid_metrics"):
        parse_config(NeRFAppConfig, args=["--config", OCTREE, "--trainer.valid-metrics",
                                          "psnr,lpips"])


def test_main_refuses_checkpoint_and_snapshot_cadences():
    """The octree yaml saves and renders every 100 epochs of its 100: both would fire, and
    neither is ported; the refusal comes before anything is built."""
    with pytest.raises(NotImplementedError) as err:
        main_nerf.main(["--config", OCTREE, "--device", "cpu"])
    msg = str(err.value)
    assert "save_every 100" in msg and "--trainer.save-every -1" in msg
    assert "render_every 100" in msg and "--trainer.render-every -1" in msg
    with pytest.raises(NotImplementedError, match="save_every 10 selects checkpoints.*"
                                                  "\\(off with --trainer.save-every -1\\)$"):
        main_nerf.parse_args(["--config", OCTREE, "--trainer.save-every", "10",
                              "--trainer.render-every", "-1"])
    cfg = main_nerf.parse_args(["--config", OCTREE, "--trainer.save-every", "200",
                                "--trainer.render-every", "-1"])
    assert cfg.trainer.save_every == 200 and cfg.device == "cuda"


def test_trainer_refuses_unported_cadences():
    """The trainer holds a config made in code to the gate ``parse_config`` runs: a
    checkpoint or snapshot cadence that would fire within max_epochs raises before anything
    is built. The port's default turns snapshots off (JAX's is 100)."""
    from wisp_tpu_torch.trainers.multiview_trainer import (ConfigMultiviewTrainer,
                                                           MultiviewTrainer)
    assert ConfigMultiviewTrainer().render_every == -1
    with pytest.raises(NotImplementedError, match="render_every 100 selects render snapshots"):
        MultiviewTrainer(ConfigMultiviewTrainer(render_every=100), None, [], device="cpu")
    with pytest.raises(NotImplementedError, match="save_every 3 selects checkpoints"):
        MultiviewTrainer(ConfigMultiviewTrainer(save_every=3, max_epochs=4), None, [],
                         device="cpu")
