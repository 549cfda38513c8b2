"""The paper's experimental tasks (Section 4) as selectable configs (port
of ``repro.configs.paper_tasks``; only synthetic(1, 1) so far — the
Shakespeare LSTM and CIFAR ResNet tasks are ROADMAP.md queue 1 item 10).
"""
from __future__ import annotations

import dataclasses

from ..models.softmax_reg import SoftmaxRegConfig

DEFERRED_TASKS = ("shakespeare", "cifar")


@dataclasses.dataclass(frozen=True)
class PaperTask:
    task_id: str
    model_cfg: object
    n_clients: int
    clients_per_round: int = 10      # paper: M = 10
    local_steps: int = 5             # E
    local_batch: int = 20            # paper: minibatch 20
    client_lr: float = 0.01
    rounds: int = 300
    beta: float = 1e-3               # paper: beta = O(1/T) = 1e-3


SYNTHETIC = PaperTask(
    task_id="synthetic11", model_cfg=SoftmaxRegConfig(dim=60, n_classes=10),
    n_clients=100, client_lr=0.01, local_batch=20)

PAPER_TASKS = {t.task_id: t for t in (SYNTHETIC,)}
