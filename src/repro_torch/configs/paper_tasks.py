"""The paper's experimental tasks (Section 4) as selectable configs (port
of ``repro.configs.paper_tasks``).

* synthetic(alpha, alpha): softmax regression, 100 clients, M=10/round.
* shakespeare: char-LM LSTM (Table 6), 715 roles -> 100-client stand-in.
* cifar100: ResNet-18 + GroupNorm, LDA(0.1) partition, 500 -> 50-client
  stand-in (raw corpora are not available offline; see DESIGN.md §9).
"""
from __future__ import annotations

import dataclasses

from ..models.resnet import ResNetConfig
from ..models.rnn import LstmConfig
from ..models.softmax_reg import SoftmaxRegConfig

# every task of the JAX package is ported
DEFERRED_TASKS = ()


@dataclasses.dataclass(frozen=True)
class PaperTask:
    task_id: str
    model_cfg: object
    n_clients: int
    clients_per_round: int = 10      # paper: M = 10
    local_steps: int = 5             # E
    local_batch: int = 20            # paper: minibatch 20 (4 for shakespeare)
    client_lr: float = 0.01
    rounds: int = 300
    beta: float = 1e-3               # paper: beta = O(1/T) = 1e-3


SYNTHETIC = PaperTask(
    task_id="synthetic11", model_cfg=SoftmaxRegConfig(dim=60, n_classes=10),
    n_clients=100, client_lr=0.01, local_batch=20)

SHAKESPEARE = PaperTask(
    task_id="shakespeare", model_cfg=LstmConfig(vocab=90, embed_dim=8,
                                                hidden=256, n_layers=2, seq_len=80),
    n_clients=100, client_lr=0.5, local_batch=4, rounds=200)

CIFAR = PaperTask(
    task_id="cifar", model_cfg=ResNetConfig(n_classes=20, width=16,
                                            stages=(1, 1, 1, 1)),
    n_clients=50, client_lr=0.05, local_batch=20, rounds=200)

PAPER_TASKS = {t.task_id: t for t in (SYNTHETIC, SHAKESPEARE, CIFAR)}
