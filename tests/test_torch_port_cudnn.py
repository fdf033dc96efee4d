"""The cuDNN engines the port refuses (`mb_istft_vits_torch/cudnn_errata.json`).

Importing the port names that file to torch's cuDNN frontend
(`CUDNN_ERRATA_JSON_FILE`), which skips the engines it lists when it ranks
a convolution's plans. Without it, torch's heuristic mode takes for the
weight gradient of the decoder ResBlocks' k=3 256-channel convolutions at
[64, 256, 128] an FFT plan with a 34.6 GB workspace whenever that
workspace fits, so the plan a training graph captures would follow the
allocator's history. The card test runs that backward in a fresh process;
it skips without a CUDA device. Imports no JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_cudnn.py
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest
import torch

import mb_istft_vits_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ERRATA = os.path.join(os.path.dirname(mb_istft_vits_torch.__file__),
                      "cudnn_errata.json")
OPERATIONS = {"ConvFwd", "ConvBwdData", "ConvBwdFilter"}


def _python(code: str, **env) -> str:
    base = {k: v for k, v in os.environ.items()
            if k != "CUDNN_ERRATA_JSON_FILE"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env={**base, **env}, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return out.stdout.strip().splitlines()[-1]


def test_importing_the_port_names_its_errata_file():
    code = ("import os, mb_istft_vits_torch; "
            "print(os.environ['CUDNN_ERRATA_JSON_FILE'])")
    assert _python(code) == ERRATA
    assert _python(code, CUDNN_ERRATA_JSON_FILE="/elsewhere.json") \
        == "/elsewhere.json"


def test_the_errata_file_is_what_the_frontend_reads():
    """The frontend's rule: `operation` and `engine` name the plans whose
    tag starts `<operation>_eng<engine>_`; `why` is for the reader."""
    with open(ERRATA) as f:
        doc = json.load(f)
    assert doc["version"] == 1 and doc["rules"]
    for rule in doc["rules"]:
        assert rule["operation"] in OPERATIONS
        assert isinstance(rule["engine"], int) and rule["engine"] >= 0
        assert rule["why"] and rule["rule_id"]


@pytest.mark.cuda
def test_the_decoder_resblock_backward_takes_no_fft_workspace():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    code = """
import json, torch
import mb_istft_vits_torch
from mb_istft_vits_torch.device import disable_tf32
disable_tf32()
conv = torch.nn.Conv1d(256, 256, 3, padding=1).cuda()
x = torch.randn(64, 256, 128, device="cuda", requires_grad=True)
y = conv(x)
torch.cuda.synchronize()
base = torch.cuda.memory_allocated()
torch.cuda.reset_peak_memory_stats()
y.backward(torch.ones_like(y))
torch.cuda.synchronize()
print(json.dumps(torch.cuda.max_memory_allocated() - base))
"""
    # both gradients are 8.4 MB and under 0.1 GB with the next plan's
    # workspace; the FFT plan's workspace is 34.6 GB
    assert json.loads(_python(code)) < 2**30
