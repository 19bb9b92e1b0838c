"""Host milliseconds a training step waits for its loss, the step's one
wait on the device: the program's span ``train.loss_fetch``
(``train/trainer.py:CLIPTrainer.step``), over the steps that lie whole
within the traced slice's device operations."""

from portbench.spans import step_ms


def read(r):
    return step_ms(r, ("train.loss_fetch",))
