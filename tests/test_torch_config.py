"""The port's config front end against the JAX package's: the yaml reader against PyYAML on
every shipped config, ``parse_config`` of the two lego-proxy NeRF configs (with and without
command-line overrides) against JAX's, field by field over the fields both configs have, the
refusals (a setting the port has not ported raises, naming its ROADMAP item), and the
settings ported since (the stochastic backward, checkpoints, resume, --pretrained, the
snapshot and checkpoint cadences) read into the objects they configure."""

import pathlib
import types

import pytest
import torch

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
STOCH = str(ROOT / "app/nerf/configs/nerf_hash_lego_proxy_stoch.yaml")
TRIPLANAR = str(ROOT / "app/nerf/configs/nerf_triplanar_lego_proxy.yaml")
CODEBOOK = str(ROOT / "app/nerf/configs/nerf_codebook_lego_proxy.yaml")
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


@pytest.mark.parametrize("config", [OCTREE, HASH, STOCH, TRIPLANAR, CODEBOOK],
                         ids=["octree", "hash", "stoch", "triplanar", "codebook"])
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
    # whose value is what the port does
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


@pytest.mark.parametrize("config,grid", [(TRIPLANAR, "TriplanarGrid"),
                                         (CODEBOOK, "CodebookOctreeGrid")],
                         ids=["triplanar", "codebook"])
def test_new_grid_configs_read_back(tmp_path, capsys, config, grid):
    """The triplanar and codebook yamls, ported since, parse to their grids and read back
    from what ``print_config`` writes."""
    cfg = main_nerf.parse_args(["--config", config])
    assert config_to_dict(cfg)["grid"]["constructor"] == grid
    main_nerf.print_config(cfg)
    path = tmp_path / "printed.yaml"
    path.write_text(capsys.readouterr().out)
    again = parse_config(NeRFAppConfig, args=["--config", str(path)])
    assert config_to_dict(again) == config_to_dict(cfg)


def test_nglod_app_refuses_the_triplanar_grid_naming_its_item():
    """main_nglod's grid union has no TriplanarGrid yet (JAX's app takes it): the front end
    refuses it with NotImplementedError naming ROADMAP Queue 1, item 7, as the app's
    docstring promises, not as an unknown constructor."""
    from wisp_tpu_torch.app.nglod import main_nglod
    nglod = str(ROOT / "app/nglod/configs/nglod_octree.yaml")
    with pytest.raises(NotImplementedError, match=r"TriplanarGrid.*Queue 1, item 7"):
        main_nglod.parse_args(["--config", nglod, "--grid.constructor", "TriplanarGrid"])


@pytest.mark.parametrize("args,match", [
    (["--config", OCTREE, "--trainer.save-valid-imgs", "true"], "save_valid_imgs"),
    (["--config", OCTREE, "--tracer.early-stop", "0.01"], "early_stop"),
    (["--config", HASH, "--trainer.render-segments", "4"], "render_segments"),
    (["--config", TRIPLANAR, "--dataset.constructor", "NeRFSyntheticDataset"],
     "NeRFSyntheticDataset.*item 5"),
    (["--config", OCTREE, "--dataset.constructor", "RTMVDataset"], "RTMVDataset"),
    (["--config", OCTREE, "--tracker.wandb", "true"], "wandb"),
    (["--config", OCTREE, "--trainer.random-lod", "true"], "random_lod"),
    (["--config", OCTREE, "--trainer.profile", "true"], "profile"),
])
def test_unported_settings_raise(args, match):
    with pytest.raises(NotImplementedError, match=match):
        parse_config(NeRFAppConfig, args=args)


# the depth cut of the build cases: the dataset's size (the yamls have 100 views of 512x512)
TINY_DATA = ["--device", "cpu", "--dataset.num-views", "2", "--dataset.height", "8",
             "--dataset.width", "8"]


def _built(tmp_path, monkeypatch, *args, tensorboard=False):
    """main_nerf.parse_args and build() on the CPU, inside ``tmp_path`` (the yaml's log and
    ground-truth dirs are relative); TensorBoard off unless asked for (its import takes
    ~15 s where tensorflow is installed)."""
    monkeypatch.chdir(tmp_path)
    extra = [] if tensorboard else ["--tracker.tensorboard", "false"]
    cfg = main_nerf.parse_args(list(args) + TINY_DATA + extra)
    return cfg, main_nerf.build(cfg)


@pytest.mark.parametrize("args,reaches", [
    (["--config", STOCH], lambda p, t: p.nef.grid.stoch_grad is True),
    (["--config", HASH, "--grid.stoch-grad", "true"],
     lambda p, t: p.nef.grid.stoch_grad is True and p.nef.grid.dense_lod_matmul == "bf16"),
    (["--config", OCTREE, "--trainer.checkpoint-every", "5"],
     lambda p, t: t.cfg.checkpoint_every == 5),
    (["--config", OCTREE, "--trainer.resume", "auto"], lambda p, t: t.cfg.resume == "auto"),
    (["--config", HASH, "--tracer.seg-early-stop", "1e-3", "--tracer.seg-count", "4"],
     lambda p, t: (p.tracer.seg_early_stop, p.tracer.seg_count) == (1e-3, 4)),
    (["--config", HASH, "--tracer.raymarch-type", "uniform"],
     lambda p, t: p.tracer.raymarch_type == "uniform" and p.tracer.march_stride == 2),
], ids=["stoch-yaml", "stoch-flag", "checkpoint-every", "resume", "seg-cull", "uniform-march"])
def test_ported_settings_reach_their_objects(tmp_path, monkeypatch, args, reaches):
    """Settings the port refused until it ported them: each is read and reaches the grid
    or the trainer that acts on it."""
    _, (pipeline, trainer, _) = _built(tmp_path, monkeypatch, *args)
    assert reaches(pipeline, trainer)


@pytest.mark.parametrize("fmt", ["full", "state_dict"])
def test_pretrained_reaches_the_pipeline(tmp_path, monkeypatch, fmt):
    """--pretrained builds the pipeline from the saved file when the format is 'full' (it
    loads whole); with 'state_dict' the app ignores it and builds the config's pipeline
    anew, as JAX's app does."""
    fmt_args = ["--trainer.model-format", fmt]
    _, (pipeline, trainer, _) = _built(tmp_path, monkeypatch, "--config", OCTREE, *fmt_args)
    with torch.no_grad():
        pipeline.nef.grid.features[0].add_(1.0)
    path = trainer.save_model()
    cfg, (loaded, _, _) = _built(tmp_path, monkeypatch, "--config", OCTREE, *fmt_args,
                                 "--pretrained", path)
    assert cfg.pretrained == path and cfg.trainer.model_format == fmt
    same = torch.equal(loaded.nef.grid.features[0], pipeline.nef.grid.features[0])
    assert same == (fmt == "full")


def test_stoch_yaml_builds_as_shipped(tmp_path, monkeypatch):
    """nerf_hash_lego_proxy_stoch.yaml through main_nerf.build() with no override but the
    device and the dataset's size: its cadences, model format, log dir, dense_lod_matmul
    and stoch_grad are read, not dropped or refused, and reach what they configure. Its
    TensorBoard dashboard is on; here, as on the card's machine, the package is missing
    (the import is made to fail), and the tracker warns and goes on."""
    from wisp_tpu_torch.trainers.tracker import tracker as tracker_mod

    def missing(log_dir):
        raise ImportError("No module named 'tensorboard'")

    monkeypatch.setattr(tracker_mod, "_Tensorboard", missing)
    with pytest.warns(UserWarning, match="tensorboard is not installed"):
        cfg, (pipeline, trainer, renderer) = _built(tmp_path, monkeypatch, "--config", STOCH,
                                                    tensorboard=True)
    assert cfg.tracker.tensorboard is True and trainer.tracker.dashboards == []
    grid = pipeline.nef.grid
    assert grid.stoch_grad is True and grid.dense_lod_matmul == "bf16"
    assert grid.num_lods == 16 and grid.codebook_bitwidth == 19 and grid.feature_dim == 2
    assert pipeline.tracer.num_steps == 512 and pipeline.tracer.march_stride == 2
    tc = trainer.cfg
    assert (tc.max_epochs, tc.save_every, tc.render_every, tc.model_format) == \
        (50, 50, 100, "full")
    assert trainer.tracker.log_dir.startswith("_results/logs/runs/nerf-hash-lego-proxy-stoch/")
    assert trainer.tracker.visualizer is renderer and renderer.width == 512
    assert trainer.tracker.get_app_config() is cfg


def test_unknown_and_dropped_keys(tmp_path):
    """An octree grid drops the hash grid's dense_lod_matmul, as JAX does; unknown keys are
    errors."""
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
    """The octree yaml saves and renders every 100 epochs of its 100: both cadences are
    ported now, and are read as given (they used to be refused); an SDF trainer still
    refuses a firing snapshot cadence (below)."""
    cfg = main_nerf.parse_args(["--config", OCTREE])
    assert (cfg.trainer.save_every, cfg.trainer.render_every) == (100, 100)
    assert cfg.trainer.max_epochs == 100 and cfg.device == "cuda"
    cfg = main_nerf.parse_args(["--config", OCTREE, "--trainer.save-every", "10",
                                "--trainer.render-every", "-1"])
    assert (cfg.trainer.save_every, cfg.trainer.render_every) == (10, -1)


def test_trainer_refuses_unported_cadences():
    """The default snapshot cadence is JAX's 100. A NeRF trainer renders on it (through the
    tracker's visualizer), and so does the SDF trainer (its sdf slices,
    tests/test_torch_nglod_app.py); the SDF trainer's training state is not ported, so it
    refuses a checkpoint cadence or a resume, naming ROADMAP Queue 1 item 7."""
    from wisp_tpu_torch.trainers.multiview_trainer import ConfigMultiviewTrainer
    from wisp_tpu_torch.trainers.sdf_trainer import ConfigSDFTrainer, SDFTrainer
    assert ConfigMultiviewTrainer().render_every == 100
    assert ConfigSDFTrainer().render_every == 100
    trainer = SDFTrainer(ConfigSDFTrainer(render_every=100, max_epochs=100), _StubPipeline(),
                         [], device="cpu")
    assert trainer.is_time_to_render() is False and trainer.cfg.render_every == 100
    with pytest.raises(NotImplementedError, match="SDF trainer's training state.*item 7"):
        SDFTrainer(ConfigSDFTrainer(render_every=-1, checkpoint_every=1), _StubPipeline(),
                   [], device="cpu")
    with pytest.raises(NotImplementedError, match="SDF trainer's training state.*item 7"):
        SDFTrainer(ConfigSDFTrainer(render_every=-1, resume="auto"), _StubPipeline(), [],
                   device="cpu")


class _StubPipeline(torch.nn.Module):
    """The least an SDF trainer needs: a parameter, and a field whose grid has LODs."""

    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.zeros(1))
        self.nef = types.SimpleNamespace(grid=types.SimpleNamespace(num_lods=1))
