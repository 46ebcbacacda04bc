"""Offline tasks of the port (counterpart of ``sigdigger_tpu/tasks``):
the cancellable task stack, the block transforms, the wave sampler, the
carrier and Doppler tasks on the PSD backend (``psdutil``), the
exporters and the TLE downloader."""

from sigdigger_tpu_torch.tasks.base import (
    CancellableTask,
    MultitaskController,
    TaskController,
    TaskProgress,
)
from sigdigger_tpu_torch.tasks.carrier import CarrierDetector, CarrierXlator
from sigdigger_tpu_torch.tasks.doppler import DopplerCalculator, DopplerResult
from sigdigger_tpu_torch.tasks.export import ExportCSVTask, ExportSamplesTask
from sigdigger_tpu_torch.tasks.sampler import (
    SamplingProperties,
    SyncMode,
    WaveSampler,
    WaveSampleSet,
)
from sigdigger_tpu_torch.tasks.transforms import (
    AGCTask,
    CostasRecoveryTask,
    DelayedConjTask,
    HistogramFeeder,
    LPFTask,
    PLLSyncTask,
    QuadDemodTask,
)

__all__ = [
    "AGCTask",
    "CancellableTask",
    "CarrierDetector",
    "CarrierXlator",
    "CostasRecoveryTask",
    "DelayedConjTask",
    "DopplerCalculator",
    "DopplerResult",
    "ExportCSVTask",
    "ExportSamplesTask",
    "HistogramFeeder",
    "LPFTask",
    "MultitaskController",
    "PLLSyncTask",
    "QuadDemodTask",
    "SamplingProperties",
    "SyncMode",
    "TaskController",
    "TaskProgress",
    "WaveSampleSet",
    "WaveSampler",
]
