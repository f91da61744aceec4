"""The `set_modes` fixture of the port's tests: `config.set_engine_modes`
for one test, with the engine modes it found restored after it.  A test
module takes it by importing it by name."""

import pytest

from image_analogies_tpu_torch.config import set_engine_modes


@pytest.fixture
def set_modes():
    prev = set_engine_modes()
    yield set_engine_modes
    set_engine_modes(prev)
