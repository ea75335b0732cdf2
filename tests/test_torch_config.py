"""The port's PyYAML-free config reader against ``yaml.safe_load``, and the
entry points' device rule.

- ``load_yaml`` on every file under ``configs/`` (the anchor and alias of
  ``graph_net.yaml``, the space before its colon, flow lists, comments) and
  on ``save_config``'s output for each overlaid config: equal to
  ``yaml.safe_load``, types included; what it does not read raises.
- ``load_config`` is the JAX package's overlay, and ``resume_training``
  reads a run's ``config.yaml`` with ``yaml`` hidden from ``sys.modules``.
- ``ModelWrapper(device=None)`` means the card: without one it raises and
  names ``device="cpu"``, and so do ``factory.get_model``,
  ``train.train_model`` and ``train.resume_training``; the CPU is taken only
  when asked, and asking changes no byte of ``config.yaml``.
"""

import glob
import json
import os
import sys

import pytest
import yaml

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # pytest-xdist runs several test processes side by side: one thread each

from point_cloud_classifier_tpu.utils import config as jax_config  # noqa: E402
from point_cloud_classifier_tpu_torch import factory  # noqa: E402
from point_cloud_classifier_tpu_torch import train as port_train  # noqa: E402
from point_cloud_classifier_tpu_torch.data.synthetic import write_s2ppc_cache  # noqa: E402
from point_cloud_classifier_tpu_torch.models import DeepSets, ModelWrapper  # noqa: E402
from point_cloud_classifier_tpu_torch.utils import config as port_config  # noqa: E402
from point_cloud_classifier_tpu_torch.utils.config import YamlError, load_yaml  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(os.path.basename(p) for p in glob.glob(os.path.join(REPO, "configs", "*.yaml")))
SPECIFIC = [name for name in CONFIGS if name != "base.yaml"]


def _same(got, want):
    """Equal, and of the same types all the way down (1 is not True or 1.0)."""
    assert repr(got) == repr(want)


def test_configs_are_found():
    assert "base.yaml" in CONFIGS and "graph_net.yaml" in CONFIGS and len(CONFIGS) >= 5


@pytest.mark.parametrize("name", CONFIGS)
def test_load_yaml_reads_each_config_as_safe_load(name):
    with open(os.path.join(REPO, "configs", name)) as f:
        text = f.read()
    _same(load_yaml(text), yaml.safe_load(text))


def test_graph_net_anchor_and_alias():
    with open(os.path.join(REPO, "configs", "graph_net.yaml")) as f:
        cfg = load_yaml(f.read())
    assert cfg["model"]["input_dim"] == 4 and cfg["dataset"]["n_features"] == 4


@pytest.mark.parametrize("name", SPECIFIC)
def test_load_config_overlays_as_the_jax_package(name):
    base, specific = (os.path.join(REPO, "configs", n) for n in ("base.yaml", name))
    _same(port_config.load_config(base, specific), jax_config.load_config(base, specific))


@pytest.mark.parametrize("name", SPECIFIC)
def test_load_yaml_reads_save_config_output(name, tmp_path):
    base, specific = (os.path.join(REPO, "configs", n) for n in ("base.yaml", name))
    cfg = jax_config.load_config(base, specific)
    cfg["meta"].update(model_name=name[:-5], dataset_name="s2pg")
    cfg["trainer"] = dict(cfg.get("trainer") or {}, note="it's: a #string", empty=None,
                          flags=[True, "yes", 1e-3, "1e-3", -7, [1, [2.5, "x"]], {"k": []}])
    with open(port_config.save_config(cfg, str(tmp_path))) as f:
        text = f.read()
    assert text == yaml.safe_dump(cfg)
    _same(load_yaml(text), yaml.safe_load(text))
    assert port_config.load_config(os.path.join(tmp_path, "config.yaml")) == cfg


SCALARS = """\
a: 1e-3
b: 1.0e-3
c: .5
d: 0o7
e: 010
f: 0x1F
g: +12
h: 1_000
i: ~
j:
k: on
l: 'a''b'
m: "a\\nb \\" c"
n: a#b   # a comment
o: [a, 'b, c', [1, 2], 3, "x]"]
p: -.inf
q: .NaN
r: No
s: 12abc
t: {}
u: [ ]
"""
DOCUMENTS = {
    "scalars": SCALARS,
    "anchors": "x: &a [1, 2]\ny: *a\nz: &s foo\nw: *s\nv : &n 4\nu   : *n\n",
    "sequences": "- 1\n- a: 1\n  b: 2\n- - 3\n  - 4\n-\n  - 5\n- [6]\n",
    "lists-under-keys": "a:\n  - 1\n  - 2\nb:\n- 3\n- k: v\n  l: w\nc: 4\n",
    "empty": "",
    "comments-only": "# nothing\n\n   # here\n",
    "one-scalar": "just a string",
    "nested": "a:\n  b:\n    c: 1\n  d: 2\ne:\n    f: 3\n",
    "quoted-keys": "'a b': 1\n\"c: d\": 2\n3: three\n",
}


@pytest.mark.parametrize("name", sorted(DOCUMENTS))
def test_load_yaml_types_as_safe_load(name):
    _same(load_yaml(DOCUMENTS[name]), yaml.safe_load(DOCUMENTS[name]))


@pytest.mark.parametrize(
    "text",
    ["a: {b: 1}", "a: |\n  x\n", "a: >\n  x\n", "---\na: 1\n", "a: !!str 1", "a: 2001-01-01",
     "a: 1:30", "<<: x", "a: 1\n   b: 2", "a: [1,\n 2]", "a: *nope", "a: b\n c", "a: 'open",
     "? a\n: 1", "a:\n\t b: 1", "a: 1\na: 2", "a: [1 2", "%YAML 1.1"],
)
def test_load_yaml_refuses_what_it_does_not_read(text):
    with pytest.raises(YamlError):
        load_yaml(text)


# -- the device rule, and resume_training without PyYAML ----------------------------


def _config(tmp_path, epochs=1):
    """configs/deep_sets.yaml at narrow widths (φ [16, 16] residual, ρ [16])."""
    return {
        "meta": {"model_name": "", "dataset_name": ""},
        "dataset": {"data_dir": str(tmp_path / "data"), "batch_size": 8,
                    "sparse_batching": True, "energy_cutoff": 0.015},
        "logging": {"log_dir": str(tmp_path / "log")},
        "model": {"input_dim": 6, "phi_layers": [16, 16], "rho_layers": [16],
                  "output_dim": 1, "sparse_batching": True, "pooling": "mean",
                  "layer_norm": False, "activation": "gelu", "residual_block": True},
        "trainer": {"epochs": epochs, "learning_rate": 0.001, "optimizer": "adamw"},
    }


@pytest.fixture
def data_dir(tmp_path):
    write_s2ppc_cache(str(tmp_path / "data"), n_events=(24, 8, 8), min_points=3,
                      max_points=20, seed=1)
    return tmp_path


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_wrapper_without_a_card_raises_and_names_the_cpu(no_card):
    net = DeepSets(input_dim=6, phi_layers=[8, 8], rho_layers=[8], output_dim=1, activation="gelu")
    with pytest.raises(RuntimeError, match=r'device="cpu"'):
        ModelWrapper(net, learning_rate=1e-3, epochs=1)
    assert ModelWrapper(net, learning_rate=1e-3, epochs=1, device="cpu").device.type == "cpu"


def test_wrapper_default_device_is_the_card(monkeypatch):
    """With a card reported, ``device=None`` resolves to ``cuda``: never the CPU."""
    from point_cloud_classifier_tpu_torch.models import wrapper

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert wrapper.resolve_device(None) == torch.device("cuda")
    assert wrapper.resolve_device("cpu") == torch.device("cpu")


@pytest.mark.parametrize("entry", ["get_model", "train_model", "resume_training"])
def test_entry_points_take_the_cpu_only_when_asked(entry, data_dir, no_card):
    cfg = _config(data_dir)
    cfg["meta"].update(model_name="deep_sets", dataset_name="s2ppc")
    calls = {
        "get_model": lambda **kw: factory.get_model("deep_sets", cfg, **kw),
        "train_model": lambda **kw: port_train.train_model("deep_sets", "s2ppc", cfg, **kw),
        "resume_training": lambda **kw: port_train.resume_training(str(data_dir / "run"), cfg, **kw),
    }
    with pytest.raises(RuntimeError, match=r'device="cpu"'):
        calls[entry]()
    if entry == "get_model":
        assert calls[entry](device="cpu").device.type == "cpu"


def test_resume_training_reads_config_yaml_without_pyyaml(data_dir, monkeypatch):
    cfg = _config(data_dir)
    log_dir = port_train.train_model("deep_sets", "s2ppc", cfg, return_log_dir=True, device="cpu")
    path = os.path.join(log_dir, "config.yaml")
    with open(path) as f:
        text = f.read()
    # asking for the CPU is no part of the run's config
    assert "device" not in text and "cpu" not in text and text == yaml.safe_dump(cfg)
    with open(path, "w") as f:
        f.write(text.replace("epochs: 1", "epochs: 2"))
    monkeypatch.setitem(sys.modules, "yaml", None)  # `import yaml` now raises
    with pytest.raises(ImportError):
        import yaml as _  # noqa: F401
    model = port_train.resume_training(log_dir, device="cpu")
    assert model.device.type == "cpu" and model.epochs == 2
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        losses = [json.loads(line) for line in f]
    assert len([row for row in losses if row["tag"] == "Loss/train"]) == 2
