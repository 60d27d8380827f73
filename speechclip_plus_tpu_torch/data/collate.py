"""Batching: static-shape padding, length bucketing, multi-process decode.

Port of ``speechclip_plus_tpu/data/collate.py``, numpy only: the seeded
shuffle, `set_epoch`, the crops and the `valid` mask are the JAX package's,
bit for bit, so both packages train on the same batches. The reference
collates ragged wav lists with `pad_sequence`
(`avssl/data/collate_function.py:7-36`) and feeds a torch DataLoader with
`njobs` worker processes (`avssl/task/base_task.py:137-169`). A few fixed
shapes keep the kernels' shapes few, so here:

  - waveforms are random-cropped (train) then padded up to one of a few
    BUCKET lengths -> a handful of compiled graphs instead of one per length;
  - every batch carries `wav`, `wav_len`, `image`, `id`, `text` and a `valid`
    row mask so the final partial batch can be padded to the full batch size
    (padded rows are excluded from the loss via `valid`);
  - host decode (wav read + resample, JPEG decode, BPE) runs in
    `num_workers` forked worker processes (the reference's njobs
    equivalent), each producing whole collated batches into a result queue;
    batch order is preserved with a reorder buffer so training is
    worker-count-invariant. `num_workers=0` runs one background
    prefetch thread (fine for cached/synthetic data and tests);
  - under data parallelism (`set_shard(rank, world)`) every rank walks the
    same shuffle and crop seeds and decodes only its rows of each global
    batch (padded to a multiple of the ranks with `valid=False` rows); the
    other rows' lengths, which the crop stream and the bucket need, come from
    the wav headers (`dataset.wav_length`). Concatenated over the ranks the
    batches are the single-process batches, row for row.
"""
from __future__ import annotations

import multiprocessing as mp
import queue
import threading
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

__all__ = ["pad_to_bucket", "collate_batch", "BucketedLoader", "DEFAULT_BUCKETS"]

# multiples of the HuBERT stride (320); top = reference max_audio_len 102400.
# The low end matters: short utterances (or short max_audio_len crops in
# tiny/dev configs) must not pad up to 16000 samples — that multiplies frame
# counts, attention cost and compile time for nothing.
DEFAULT_BUCKETS = (1920, 3840, 7680, 16000, 32000, 48000, 64000, 80000, 102400)


def pad_to_bucket(length: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if length <= b:
            return b
    return buckets[-1]


def collate_batch(
    samples: List[Dict],
    buckets: Sequence[int] = DEFAULT_BUCKETS,
    pad_to_size: Optional[int] = None,
    longest: Optional[int] = None,
) -> Dict[str, np.ndarray]:
    """Stack a list of dataset items into one padded numpy batch. `longest`
    (a rank's shard) is the global batch's longest wav, whose bucket every
    shard takes."""
    n = len(samples)
    out: Dict[str, np.ndarray] = {}
    if "wav" in samples[0]:
        lens = np.array([min(len(s["wav"]), buckets[-1]) for s in samples], np.int32)
        t = pad_to_bucket(int(lens.max()) if longest is None else longest, buckets)
        wav = np.zeros((n, t), np.float32)
        for i, s in enumerate(samples):
            w = s["wav"][: lens[i]]
            wav[i, : len(w)] = w
        out["wav"] = wav
        out["wav_len"] = lens
    if "image" in samples[0]:
        out["image"] = np.stack([s["image"] for s in samples]).astype(np.float32)
    if "image_feat" in samples[0]:
        out["image_feat"] = np.stack(
            [s["image_feat"] for s in samples]
        ).astype(np.float32)
    if "text" in samples[0] and not isinstance(samples[0]["text"], str):
        out["text"] = np.stack([np.asarray(s["text"], np.int32) for s in samples])
    if "id" in samples[0]:
        out["id"] = np.array([int(s["id"]) for s in samples], np.int32)
    out["valid"] = np.ones((n,), bool)

    if pad_to_size is not None and n < pad_to_size:
        pad = pad_to_size - n
        for k, v in list(out.items()):
            out[k] = np.concatenate(
                [v, np.zeros((pad,) + v.shape[1:], v.dtype)], axis=0
            )
        out["valid"][n:] = False
    return out


def _wav_length(dataset, index: int) -> int:
    """A row's wav length at the dataset's rate, from its header where the
    dataset can read one."""
    if hasattr(dataset, "wav_length"):
        return int(dataset.wav_length(int(index)))
    return len(dataset[int(index)]["wav"])


def _decode_batch(
    dataset, indices, crop_seed: int, *, batch_size, drop_last, buckets,
    max_audio_len, train, shard=(0, 1),
) -> Dict[str, np.ndarray]:
    """Pure batch decode+collate; module-level so worker processes can run
    it. One crop-rng per batch keyed on `crop_seed` makes the result
    identical whatever worker (or thread) executes it. `shard` (rank, world)
    decodes rank's rows of the global batch (padded to a multiple of world),
    drawing the other rows' crops from their lengths alone."""
    from .audio import random_crop_max_length

    rng = np.random.RandomState(crop_seed & 0x7FFFFFFF)
    crop = train and max_audio_len > 0
    pad_to = batch_size if not drop_last else None
    rank, world = shard
    total = max(len(indices), pad_to or 0)
    per = (total + (-total) % world) // world
    lo, hi = rank * per, (rank + 1) * per
    samples, longest = [], 0
    for j, i in enumerate(indices):
        if lo <= j < hi:
            s = dict(dataset[int(i)])
            if crop and "wav" in s:
                s["wav"] = random_crop_max_length(s["wav"], max_audio_len, rng=rng)
            samples.append(s)
            length = len(s["wav"]) if "wav" in s else 0
        else:  # another rank's row: advance the crop stream as its decode would
            length = _wav_length(dataset, i)
            if crop and length > max_audio_len:
                rng.randint(0, length - max_audio_len + 1)
                length = max_audio_len
        longest = max(longest, min(length, buckets[-1]))
    if not samples:  # a shard of padding alone: the keys and shapes of a row, zeroed
        out = collate_batch([dict(dataset[int(indices[0])])], buckets, pad_to_size=per,
                            longest=longest)
        return {k: np.zeros_like(v) for k, v in out.items()}
    return collate_batch(samples, buckets, pad_to_size=per, longest=longest)


def _worker_main(dataset, decode_kw, task_q, result_q):
    """Persistent decode-worker loop (module-level: spawn/forkserver need a
    picklable target). Exits on the None sentinel. Tasks/results carry a
    generation id so results from an abandoned epoch iteration (e.g. a
    preemption return mid-epoch) are dropped instead of misdelivered to the
    next epoch's identical seq numbers."""
    while True:
        item = task_q.get()
        if item is None:
            return
        gen, seq, idxs, seed = item
        try:
            result_q.put(
                (gen, seq, _decode_batch(dataset, idxs, seed, **decode_kw))
            )
        except Exception as e:  # surface decode errors to the consumer
            try:
                result_q.put((gen, seq, e))
            except Exception:
                result_q.put(
                    (gen, seq, RuntimeError(f"unpicklable worker error: {e!r}"))
                )


class BucketedLoader:
    """Iterates epoch batches with optional shuffling, length-sorted
    bucketing (less padding waste) and prefetch via `num_workers` persistent
    decode worker processes (0 = one background thread).

    Workers use the `forkserver` start method (`spawn` where it is missing): plain
    `fork` from a process with an initialized CUDA context deadlocks or
    fails in the child (the CUDA runtime's threads and handles do not survive a
    fork); the workers import no torch and touch no device. The pool starts
    lazily on first iteration, survives across epochs (each worker pays the
    interpreter+import cost once), and requires the dataset to be picklable
    — all shipped datasets are plain path/list/array holders."""

    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = True,
        drop_last: bool = False,
        buckets: Sequence[int] = DEFAULT_BUCKETS,
        max_audio_len: int = -1,
        train: bool = False,
        seed: int = 0,
        prefetch: int = 2,
        sort_by_length: bool = False,
        num_workers: int = 0,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.buckets = tuple(buckets)
        self.max_audio_len = max_audio_len
        self.train = train
        self.seed = seed
        self.prefetch = prefetch
        self.sort_by_length = sort_by_length
        self.num_workers = max(int(num_workers), 0)
        self._epoch = 0
        self._shard = (0, 1)  # (rank, world): this process decodes rank's rows
        self._pool = None  # (ctx, procs, task_q, result_q), lazily started
        self._gen = 0  # iteration generation, for dropping stale results

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def set_epoch(self, epoch: int) -> None:
        """Position the per-epoch shuffle stream (order seeds on
        seed+epoch); the Trainer calls this after a resume so training
        continues the interrupted stream instead of replaying epoch 0."""
        self._epoch = int(epoch)

    def set_shard(self, rank: int, world: int) -> None:
        """Decode only rank's rows of each global batch (data parallelism;
        the module docstring). Under tensor parallelism `rank` and `world` are
        the data coordinates, so that the ranks of a model group decode the
        same rows. The worker pool restarts with the new shard."""
        if (rank, world) != self._shard:
            self.close()
            self._shard = (int(rank), int(world))

    def _index_order(self, rng: np.random.RandomState) -> np.ndarray:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            rng.shuffle(idx)
        return idx

    @property
    def _decode_kw(self) -> Dict:
        return dict(
            batch_size=self.batch_size, drop_last=self.drop_last,
            buckets=self.buckets, max_audio_len=self.max_audio_len,
            train=self.train, shard=self._shard,
        )

    def _make_batch(self, indices, crop_seed: int) -> Dict[str, np.ndarray]:
        return _decode_batch(self.dataset, indices, crop_seed, **self._decode_kw)

    def _epoch_batches(self) -> List[np.ndarray]:
        rng = np.random.RandomState(self.seed + self._epoch)
        order = self._index_order(rng)
        batches = [
            order[i : i + self.batch_size]
            for i in range(0, len(order), self.batch_size)
        ]
        if self.drop_last and batches and len(batches[-1]) < self.batch_size:
            batches.pop()
        return batches

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        epoch = self._epoch
        self._epoch += 1
        batches = self._epoch_batches()
        # one crop-rng seed per batch: decode results are identical whatever
        # worker executes the batch (worker-count-invariant training)
        seeds = [self.seed * 1_000_003 + epoch * 131_071 + i
                 for i in range(len(batches))]
        if self.num_workers > 0:
            yield from self._iter_multiprocess(batches, seeds)
        else:
            yield from self._iter_thread(batches, seeds)

    # ---- single background decode thread (tests, cached/synthetic data) ----

    def _iter_thread(self, batches, seeds) -> Iterator[Dict[str, np.ndarray]]:
        q: "queue.Queue" = queue.Queue(maxsize=max(self.prefetch, 1))
        stop = object()
        # set when the consumer abandons iteration (preemption return,
        # exception, test teardown): without it the producer blocks forever
        # on a full queue — a leaked thread pinning its decoded batches
        abandoned = threading.Event()

        def _put(item) -> bool:
            while not abandoned.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                for b, s in zip(batches, seeds):
                    if not _put(self._make_batch(b, s)):
                        return
            finally:
                _put(stop)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is stop:
                    break
                yield item
        finally:
            # the producer ends within one decode and one 0.1 s wait: join it,
            # so that no thread of the loader outlives the iteration (a daemon
            # thread still running at interpreter exit is killed wherever it
            # stands)
            abandoned.set()
            t.join()

    # ---- persistent worker-process pool (the reference's njobs) ----

    def _ensure_pool(self):
        if self._pool is not None:
            return self._pool
        try:
            ctx = mp.get_context("forkserver")
        except ValueError:
            ctx = mp.get_context("spawn")
        task_q = ctx.Queue()
        result_q = ctx.Queue(maxsize=max(self.prefetch, self.num_workers))
        procs = [
            ctx.Process(
                target=_worker_main,
                args=(self.dataset, self._decode_kw, task_q, result_q),
                daemon=True,
            )
            for _ in range(self.num_workers)
        ]
        for p in procs:
            p.start()
        self._pool = (procs, task_q, result_q)
        return self._pool

    def close(self) -> None:
        """Shut the worker pool down (idempotent)."""
        if self._pool is None:
            return
        procs, task_q, _ = self._pool
        self._pool = None
        try:
            for _ in procs:
                task_q.put(None)
            for p in procs:
                p.join(timeout=5)
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()

    def __del__(self):  # best-effort cleanup
        try:
            self.close()
        except Exception:
            pass

    def _iter_multiprocess(self, batches, seeds) -> Iterator[Dict[str, np.ndarray]]:
        procs, task_q, result_q = self._ensure_pool()
        # generation id: an abandoned iteration (preemption return mid-epoch,
        # consumer exception) leaves stale tasks/results in flight whose seq
        # numbers would collide with the next epoch's — tag and drop them
        self._gen += 1
        gen = self._gen
        for seq, (b, s) in enumerate(zip(batches, seeds)):
            task_q.put((gen, seq, np.asarray(b), s))

        pending: Dict[int, Dict[str, np.ndarray]] = {}
        next_seq = 0
        while next_seq < len(batches):
            while next_seq not in pending:
                if not any(p.is_alive() for p in procs):
                    raise RuntimeError("all decode workers died")
                try:
                    rgen, seq, payload = result_q.get(timeout=300)
                except queue.Empty as e:
                    raise RuntimeError("decode workers stalled (300 s)") from e
                if rgen != gen:
                    continue  # stale result from an abandoned iteration
                if isinstance(payload, Exception):
                    self.close()
                    raise payload
                pending[seq] = payload
            yield pending.pop(next_seq)
            next_seq += 1
