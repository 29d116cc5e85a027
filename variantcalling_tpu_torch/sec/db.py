"""SEC systematic-error database: per-locus cohort allele-count distributions.

Counterpart of ``variantcalling_tpu/sec/db.py``. The DB stores, for every
known-noisy locus, the cohort-aggregated allele-count distribution: packed
``(contig_idx << 40) | pos`` int64 locus keys, sorted, an (L, A) float32
count table (A = ref + 3 alt slots + other) and the cohort's sample count.

The file is the reference's h5py layout, written and read by the port's
own HDF5 code (:mod:`io.hdf5`): a root attribute ``n_samples`` (int64),
``contigs`` as variable-length UTF-8 strings, ``keys`` int64 and
``counts`` float32. A DB written by either package loads in the other.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from variantcalling_tpu_torch.io import hdf5

N_ALLELE_SLOTS = 5  # ref, alt1, alt2, alt3, other


def _contig_codes(cmap: dict[str, int], chrom, missing: int | None = None) -> np.ndarray:
    """Each record's contig index through ``cmap``, one dictionary lookup a
    distinct name; an unknown name gives ``missing``, or raises ``KeyError``
    where ``missing`` is None (the reference's ``cmap[c]``)."""
    chrom = np.asarray(chrom, dtype=object)
    if len(chrom) == 0:
        return np.zeros(0, dtype=np.int64)
    names, inverse = np.unique(chrom, return_inverse=True)
    codes = np.asarray([cmap[c] if missing is None else cmap.get(c, missing) for c in names], dtype=np.int64)
    return codes[inverse.reshape(-1)]


@dataclass
class SecDb:
    contigs: list[str]  # contig name per index used in keys
    keys: np.ndarray  # int64 (L,) sorted packed (contig_idx << 40) | pos (1-based)
    counts: np.ndarray  # float32 (L, N_ALLELE_SLOTS) cohort noise allele counts
    n_samples: int

    def __len__(self) -> int:
        return len(self.keys)

    def contig_index(self) -> dict[str, int]:
        return {c: i for i, c in enumerate(self.contigs)}

    def lookup(self, chrom, pos) -> tuple[np.ndarray, np.ndarray]:
        """(hit mask, row index) for (chrom, 1-based pos) arrays."""
        cidx = _contig_codes(self.contig_index(), chrom, missing=-1)
        key = (cidx << 40) | np.asarray(pos, dtype=np.int64)
        if len(self.keys) == 0:
            return np.zeros(len(cidx), dtype=bool), np.zeros(len(cidx), dtype=np.int64)
        loc = np.minimum(np.searchsorted(self.keys, key), len(self.keys) - 1)
        hit = (self.keys[loc] == key) & (cidx >= 0)
        return hit, loc

    def save(self, path: str) -> None:
        contigs = np.empty(len(self.contigs), dtype=object)
        contigs[:] = [str(c) for c in self.contigs]
        hdf5.write_file(path, hdf5.WGroup(
            attrs={"n_samples": np.int64(self.n_samples)},
            members={"contigs": hdf5.WDataset(contigs),
                     "keys": hdf5.WDataset(np.ascontiguousarray(self.keys, dtype=np.int64)),
                     "counts": hdf5.WDataset(np.ascontiguousarray(self.counts, dtype=np.float32))}))

    @staticmethod
    def load(path: str) -> "SecDb":
        with hdf5.H5File(path) as f:
            root = f.root
            contigs = [c.decode() if isinstance(c, bytes) else str(c) for c in root["contigs"][()]]
            return SecDb(
                contigs=contigs,
                keys=np.asarray(root["keys"][()], dtype=np.int64),
                counts=np.asarray(root["counts"][()], dtype=np.float32).reshape(-1, N_ALLELE_SLOTS),
                n_samples=int(root.attrs["n_samples"]),
            )


def pack_keys(contigs: list[str], chrom, pos) -> np.ndarray:
    cidx = _contig_codes({c: i for i, c in enumerate(contigs)}, chrom)
    return (cidx << 40) | np.asarray(pos, dtype=np.int64)


def merge_sample_counts(
    contigs: list[str],
    per_sample: list[tuple[np.ndarray, np.ndarray]],  # (keys, (l, A) counts) per sample
) -> SecDb:
    """Union of loci, summed counts: the host merge (``np.add.at`` in float32)."""
    all_keys = np.unique(np.concatenate([k for k, _ in per_sample])) if per_sample else np.array([], np.int64)
    counts = np.zeros((len(all_keys), N_ALLELE_SLOTS), dtype=np.float32)
    for keys, c in per_sample:
        idx = np.searchsorted(all_keys, keys)
        np.add.at(counts, idx, c.astype(np.float32))
    return SecDb(contigs=list(contigs), keys=all_keys, counts=counts, n_samples=len(per_sample))
