"""The port's shell entry points (scripts/run_train_torch.sh,
scripts/run_evaluate_torch.sh): each parses as bash, names only modules of
aec_tpu_torch that resolve, and passes each of them only flags its parser
defines."""

import importlib.util
import re
import shutil
import subprocess
from pathlib import Path

import pytest

SCRIPTS = Path(__file__).resolve().parents[1] / "scripts"


@pytest.mark.parametrize("name", ["run_train_torch.sh", "run_evaluate_torch.sh"])
def test_torch_script_parses_and_names_port_modules(name):
    bash = shutil.which("bash")
    assert bash, "bash is needed to run the scripts"
    path = SCRIPTS / name
    subprocess.run([bash, "-n", str(path)], check=True)
    text = path.read_text()
    calls = re.findall(r"python -m (\S+)((?:[^\n]*\\\n)*[^\n]*)", text)
    assert calls and all(mod.startswith("aec_tpu_torch.cli.") for mod, _ in calls)
    for mod, args in calls:
        spec = importlib.util.find_spec(mod)
        assert spec is not None and spec.origin, mod
        source = Path(spec.origin).read_text()
        for flag in re.findall(r"(--[a-z_-]+)", args):
            assert f'"{flag}"' in source, f"{mod} defines no {flag}"
