"""Resident warmed state of the serving daemon.

Counterpart of ``variantcalling_tpu/serve/state.py``. The per-run loads a
warm request must not pay again, the model unpickle and the FASTA reader
with its encoded contigs, are held here keyed by file identity
``(abspath, size, mtime_ns)``, so a changed file on disk is picked up (its
stale entry ages out of the bounded FIFO). Below them, the process-level
caches of the pipeline were built for a long-lived process already: the
resident device genome (``featurize.device_genome``, with its leases) and
the built predictors, with their kernel tables on the card
(``pipelines/filter_variants.predictor_for``).

Thread safety: :class:`~variantcalling_tpu_torch.utils.keyed_cache.KeyedCache`
(the reference's ``_KeyedCache``): two requests for one model wait on one
load; requests for different models load at once.
"""

from __future__ import annotations

import os

from variantcalling_tpu_torch.utils.keyed_cache import KeyedCache

#: bounded FIFO sizes: models are small (pickles), genomes hold memory maps
_MAX_MODELS = 8
_MAX_FASTAS = 2


def file_identity(path: str) -> tuple[str, int, int]:
    st = os.stat(path)
    return (os.path.abspath(path), int(st.st_size), int(st.st_mtime_ns))


class ResidentState:
    """The daemon's warmed state: resident models and FASTA readers."""

    def __init__(self):
        self._models = KeyedCache("model", _MAX_MODELS)
        self._fastas = KeyedCache("genome", _MAX_FASTAS)

    def get_model(self, model_file: str, model_name: str):
        from variantcalling_tpu_torch.models.registry import load_model

        key = (*file_identity(model_file), model_name)
        return self._models.get(key, lambda: load_model(model_file, model_name))

    def get_fasta(self, reference_file: str):
        from variantcalling_tpu_torch.io.fasta import FastaReader

        return self._fastas.get(file_identity(reference_file), lambda: FastaReader(reference_file))

    def stats(self) -> dict:
        from variantcalling_tpu_torch.pipelines import filter_variants

        return {"models": self._models.stats(), "genomes": self._fastas.stats(),
                "predictors": filter_variants.predictor_cache_stats()}
