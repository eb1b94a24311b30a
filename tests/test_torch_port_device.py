"""simulst_tpu_torch's entry points run on the card unless the caller asks
for another device, and nothing of the port imports JAX or the JAX
package.  No card is needed: moving a module is intercepted and the device
it was asked for recorded."""
import pathlib
import re

import pytest

torch = pytest.importorskip("torch")

from simulst_tpu_torch.models import s2t_emformer as s2t  # noqa: E402
from simulst_tpu_torch.models.cif import CIFConfig, CIFModel  # noqa: E402
from simulst_tpu_torch.models.mma import MMAConfig, MMAModel  # noqa: E402
from simulst_tpu_torch.models.mt_transformer import (MTConfig,  # noqa: E402
                                                     MTTransformerModel)
from simulst_tpu_torch.nn import transformer as tfm  # noqa: E402
from simulst_tpu_torch.train.loop import LoopConfig, Trainer  # noqa: E402
from simulst_tpu_torch.train.optim import OptimConfig  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
S2T = dict(vocab_size=40, input_feat=8, conv_channels=16, embed_dim=32,
           ffn_dim=64, encoder_layers=1, decoder_layers=1, encoder_heads=2,
           decoder_heads=2, decoder_ffn_dim=64)
MT = dict(vocab_size=40, embed_dim=32, ffn_dim=64, encoder_layers=1,
          decoder_layers=1, num_heads=2)


@pytest.fixture
def moves(monkeypatch):
    """Record the device of every nn.Module.to call instead of moving."""
    asked = []

    def to(self, *args, **kwargs):
        asked.append(torch.device(args[0] if args else kwargs["device"]))
        return self

    monkeypatch.setattr(torch.nn.Module, "to", to)
    return asked


@pytest.mark.parametrize("entry", [
    lambda: s2t.S2TEmformerModel(s2t.S2TEmformerConfig(**S2T)),
    lambda: s2t.S2TEmformerEncoder(s2t.S2TEmformerConfig(**S2T)),
    lambda: tfm.Decoder(tfm.DecoderConfig(vocab_size=40, embed_dim=32,
                                          ffn_dim=64, num_layers=1,
                                          num_heads=2, encoder_embed_dim=32)),
    lambda: MTTransformerModel(MTConfig(**MT)),
    lambda: MMAModel(MMAConfig(**S2T)),
    lambda: CIFModel(CIFConfig(**S2T)),
], ids=["S2TEmformerModel", "S2TEmformerEncoder", "Decoder",
        "MTTransformerModel", "MMAModel", "CIFModel"])
def test_models_default_to_the_card(moves, entry):
    entry()
    assert moves and moves[-1].type == "cuda"


def test_trainer_defaults_to_the_card(moves, tmp_path):
    model = MTTransformerModel(MTConfig(**MT), device="cpu")
    moves.clear()
    trainer = Trainer(lambda *a: None, OptimConfig(),
                      LoopConfig(save_dir=str(tmp_path)), model)
    assert trainer.device.type == "cuda" and moves[-1].type == "cuda"


def test_port_and_chip_smoke_import_no_jax():
    """A grep over every source of the port and chip_smoke.py."""
    pattern = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|simulst_tpu)\b",
                         re.M)
    files = [ROOT / "chip_smoke.py",
             *sorted((ROOT / "simulst_tpu_torch").rglob("*.py"))]
    bad = [str(f.relative_to(ROOT)) for f in files
           if pattern.search(f.read_text())]
    assert len(files) > 20 and not bad, bad
