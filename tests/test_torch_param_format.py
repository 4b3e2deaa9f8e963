"""v1 parameter files (``Parameter::save``) across the two packages, on the
CPU: files written by ``paddle_tpu.compat.param_format.save_v1_param``
read by the port and the other way round, bit for bit; a model directory
through ``--init_model_path DIR`` (parameters by name, the size check,
a missing parameter kept with a warning); the header checks."""

import os
import struct

import numpy as np
import pytest
import torch

from paddle_tpu.compat import param_format as jpf
from paddle_tpu_torch.compat import param_format as tpf
from paddle_tpu_torch.trainer import cli


@pytest.mark.parametrize("shape", [(7,), (3, 5), (2, 3, 4)])
def test_v1_files_cross_both_ways(tmp_path, shape):
    rng = np.random.default_rng(len(shape))
    value = rng.normal(size=shape).astype(np.float32)
    jpath, tpath = str(tmp_path / "jax_w"), str(tmp_path / "port_w")
    jpf.save_v1_param(jpath, value)
    tpf.save_v1_param(tpath, value)
    with open(jpath, "rb") as f, open(tpath, "rb") as g:
        assert f.read() == g.read()
    np.testing.assert_array_equal(tpf.load_v1_param(jpath),
                                  value.reshape(-1))
    np.testing.assert_array_equal(jpf.load_v1_param(tpath),
                                  value.reshape(-1))
    assert tpf.load_v1_param(jpath).flags.writeable


def test_model_dirs_and_header_checks(tmp_path):
    params = {"_fc.w0": np.arange(6, dtype=np.float32).reshape(2, 3),
              "_fc.wbias": np.ones(3, np.float32)}
    jpf.save_v1_model_dir(str(tmp_path / "m"), params)
    (tmp_path / "m" / "done").write_text("not a parameter")
    got = tpf.load_v1_model_dir(str(tmp_path / "m"))
    assert sorted(got) == sorted(params)
    for k, v in params.items():
        np.testing.assert_array_equal(got[k], v.reshape(-1))
    tpf.save_v1_model_dir(str(tmp_path / "t"), params)
    back = jpf.load_v1_model_dir(str(tmp_path / "t"))
    for k, v in params.items():
        np.testing.assert_array_equal(back[k], v.reshape(-1))
    bad = tmp_path / "bad"
    bad.write_bytes(struct.pack("<iIQ", 1, 4, 1) + b"\0" * 4)
    with pytest.raises(IOError, match="version"):
        tpf.load_v1_param(str(bad))
    bad.write_bytes(struct.pack("<iIQ", 0, 8, 1) + b"\0" * 8)
    with pytest.raises(IOError, match="valueSize"):
        tpf.load_v1_param(str(bad))
    bad.write_bytes(struct.pack("<iIQ", 0, 4, 3) + b"\0" * 4)
    with pytest.raises(IOError, match="expected 3"):
        tpf.load_v1_param(str(bad))
    bad.write_bytes(b"\0" * 5)
    with pytest.raises(IOError, match="truncated"):
        tpf.load_v1_param(str(bad))


_CONF = """
import numpy as np
from paddle_tpu_torch.config import dsl
from paddle_tpu_torch.data.types import dense_vector, integer_value

x = dsl.data(name="x", size=4)
lab = dsl.data(name="label", size=3)
out = dsl.fc(input=x, size=3, act="softmax", name="fc")
cost = dsl.classification_cost(input=out, label=lab)
feeding = {"x": dense_vector(4), "label": integer_value(3)}

def train_reader():
    rng = np.random.RandomState(0)
    yield [(rng.randn(4).astype(np.float32), int(rng.randint(3)))
           for _ in range(8)]
"""


def test_init_model_path_dir_loads_by_name(tmp_path, capsys, monkeypatch):
    """``--init_model_path DIR`` loads each parameter of the directory by
    name (here ``--job test`` reports the loaded model's cost), refuses a
    file of the wrong size, and keeps a missing parameter's
    initialisation."""
    conf = tmp_path / "conf.py"
    conf.write_text(_CONF)
    w = np.linspace(-1, 1, 12, dtype=np.float32).reshape(4, 3)
    b = np.array([0.1, -0.2, 0.3], np.float32)
    model = tmp_path / "pass-00000"
    jpf.save_v1_model_dir(str(model), {"_fc.w0": w, "_fc.wbias": b})
    seen = {}
    real = cli._build_trainer

    def spy(ns, args):
        tr = real(ns, args)
        seen["params"] = {k: v.clone() for k, v in tr.params.items()}
        return tr

    monkeypatch.setattr(cli, "_build_trainer", spy)
    assert cli.main(["--config", str(conf), "--job", "test", "--device",
                     "cpu", "--init_model_path", str(model)]) == 0
    assert "Test: cost=" in capsys.readouterr().out
    assert torch.equal(seen["params"]["_fc.w0"], torch.from_numpy(w))
    assert torch.equal(seen["params"]["_fc.wbias"], torch.from_numpy(b))
    jpf.save_v1_param(str(model / "_fc.wbias"), np.ones(4, np.float32))
    with pytest.raises(ValueError, match="4 values"):
        cli.main(["--config", str(conf), "--job", "test", "--device", "cpu",
                  "--init_model_path", str(model)])
    os.remove(model / "_fc.wbias")
    assert cli.main(["--config", str(conf), "--job", "test", "--device",
                     "cpu", "--init_model_path", str(model)]) == 0
    assert torch.equal(seen["params"]["_fc.w0"], torch.from_numpy(w))
