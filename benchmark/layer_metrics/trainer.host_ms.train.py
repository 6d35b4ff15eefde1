"""Host time of one training step, from the batch's upload to Adam's
dispatch (no synchronize: where the card keeps up, the launches): the
``trainer.train_step`` span's total time per step.
"""

from benchmark.layer_metrics import _spans


def read(reading):
    return _spans.ms_per("trainer.train_step", "total_s",
                         "trainer.train_step")
