"""Host milliseconds a training step spends issuing its work: the
program's spans ``train.forward``, ``train.backward`` and
``train.optimizer`` (``train/trainer.py:CLIPTrainer.step``), over the
steps that lie whole within the traced slice's device operations."""

from portbench.spans import LAUNCH, step_ms


def read(r):
    return step_ms(r, LAUNCH)
