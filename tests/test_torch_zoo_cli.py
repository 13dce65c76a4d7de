"""Zoo training from the CLI: cli.train for every family without JAX,
and its device-cache guard (split out of tests/test_torch_zoo_train.py;
the helpers are tests/torch_zoo_common.py)."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from aec_tpu_torch.pipeline import h5io as th5
from torch_zoo_common import NARROW, ROOT, _make_dataset


@pytest.mark.parametrize("model", ["two_layer_gru", "dccrn", "fullsubnet", "att_ccrn"])
def test_cli_trains_every_family_without_jax(tmp_path, rng, model):
    """aec_tpu_torch.cli.train's main with --model M --device cpu trains one
    epoch (DCCRN and ATT-CCRN narrowed, NARROW) with jax and the JAX package
    blocked; the checkpoint carries the family's model_state (JAX's
    GenericTrainer layout) where it has one."""
    paths, cv = _make_dataset(tmp_path, rng)
    lst = str(tmp_path / "tr_list.txt")
    th5.write_filelist(lst, paths)
    exp = str(tmp_path / "exp")
    narrow = ""
    if model in NARROW:
        module, name, kw, _ = NARROW[model]
        narrow = (f"import functools, importlib\nm = importlib.import_module({module!r})\n"
                  f"m.{name} = functools.partial(m.{name}, **{kw!r})\n")
    code = (
        "import sys\n"
        "sys.modules['jax'] = sys.modules['aec_tpu'] = None\n"
        + narrow +
        "from aec_tpu_torch.cli.train import main\n"
        f"main(['--tr_list', {lst!r}, '--cv_file', {cv!r}, '--ckpt_dir', {exp!r},\n"
        f"      '--model', {model!r}, '--batch_size', '2', '--max_n_epochs', '1',\n"
        "      '--device', 'cpu'])\n"
        "assert not any(m.split('.')[0] in ('jax', 'aec_tpu') for m, v in sys.modules.items()"
        " if v is not None)\n"
        "print('ok')\n"
    )
    env = {**os.environ, "PYTHONPATH": os.path.abspath(ROOT)}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().splitlines()[-1] == "ok"
    with np.load(os.path.join(exp, "models", "latest.npz")) as data:
        keys = list(data)
    assert any(k.startswith("['params']") for k in keys)
    assert any(k.startswith("['model_state']") for k in keys) == (model in ("dccrn", "att_ccrn"))
    if model != "two_layer_gru":
        assert json.loads(open(os.path.join(exp, "metrics.jsonl")).read())["model"] == model


def test_cli_refuses_device_cache_for_stateful_families(tmp_path, rng, capsys):
    """--device_cache with a GenericTrainer family exits with JAX's message;
    two_layer_gru trains on the cached corpus, as JAX's does."""
    from aec_tpu_torch.cli.train import main

    paths, cv = _make_dataset(tmp_path, rng, n_utts=1)
    lst = str(tmp_path / "l.txt")
    th5.write_filelist(lst, paths)
    base = ["--tr_list", lst, "--cv_file", cv, "--ckpt_dir", str(tmp_path), "--device", "cpu",
            "--device_cache", "int16"]
    with pytest.raises(SystemExit) as e:
        main(base + ["--model", "dccrn"])
    assert e.value.code == 2
    assert "the stateful trainer keeps the host loader" in capsys.readouterr().err
    main(base + ["--model", "two_layer_gru", "--batch_size", "1", "--max_n_epochs", "1"])
    with open(str(tmp_path / "metrics.jsonl")) as f:
        assert "epoch_time_s" in json.loads(f.readline())
    assert os.path.isfile(str(tmp_path / "models" / "latest.npz"))
