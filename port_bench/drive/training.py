"""The base of the training drivers: the program's trainer, fed by its
``Loader``, built as its training CLI builds it, from a configuration
file and a traffic file. A training method's driver is
``drive/<method>.py``, whose ``Driver`` subclasses :class:`TrainingDriver`
with the method's trainer and sampler.

A run builds one trainer, drives its first ``checked_steps`` steps
through ``fit`` and the feed (reading the program's state between steps
for the check), then ``warmup_steps`` more, and hands the same trainer
and the same feed to the window. The model is the configuration's
``program``: its registry name and the keywords it is built with, each
taken from the configuration's key of that name. The weights are the
benchmark's (made on the device from the seed by the reference's
:func:`init_weights` and loaded into the program's model by name); the
data is the benchmark's phantom set. ``fault`` breaks the timed path
underneath, for the tests that show the check fails: ``frozen`` (the
optimizer never updates), ``half_batch`` (each step sees the first half
of its batch) and ``altered`` (the loader's transform changes one label
value of every sample).
"""

from __future__ import annotations

import gc
import time
from typing import Dict, List, Optional

import torch

from port_bench.bench import trace
from port_bench.bench.feed import Feed
from port_bench.bench.inputs import phantom_slices
from port_bench.reference import data as ref_data
from port_bench.reference.net import init_weights
from port_bench.reference.precision import Precision
from port_bench.reference.train import method, norms

FAULTS = ("frozen", "half_batch", "altered")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class TrainingDriver:
    def __init__(self, config: dict, traffic: dict, seed: int, device,
                 fault: Optional[str] = None):
        if fault is not None and fault not in FAULTS:
            raise ValueError(f"unknown fault {fault!r}")
        self.config, self.traffic = config, traffic
        self.seed, self.fault = int(seed), fault
        self.device = torch.device(device)
        self.parts: Dict[str, float] = {}
        self.readings: Dict[str, object] = {}
        self._ref_batches: Optional[List[Dict[str, torch.Tensor]]] = None

    # --- what differs between methods ------------------------------------
    def _trainer(self, model, train_cfg):
        raise NotImplementedError

    def _sampler(self, n: int):
        raise NotImplementedError

    def _ref_sampler(self, n: int):
        raise NotImplementedError

    # --- building ---------------------------------------------------------
    def _model(self):
        from mamba_unet_torch.models import net_factory

        prog = self.config["program"]
        kw = {k: self.config[key] for k, key in prog["kwargs"].items()}
        model = net_factory(
            prog["registry"], generator=torch.Generator().manual_seed(
                self.seed), **kw).to(self.device)
        model.load_state_dict(init_weights(self.config, self.seed,
                                           self.device), strict=True)
        return model

    def build(self) -> None:
        from mamba_unet_torch.data.acdc import SliceDataset
        from mamba_unet_torch.data.augment import RandomGenerator
        from mamba_unet_torch.data.loader import Loader
        from mamba_unet_torch.train import TrainConfig

        tr = self.traffic
        t = time.perf_counter()
        h, w = tr["native_size"]
        self.slices = phantom_slices(tr["slices"], h, w, self.seed,
                                     self.device)
        self.parts["data_s"] = time.perf_counter() - t
        t = time.perf_counter()
        model = self._model()
        _sync(self.device)
        self.parts["model_s"] = time.perf_counter() - t
        t = time.perf_counter()
        train_cfg = TrainConfig(
            base_lr=tr["base_lr"], max_iterations=tr["max_iterations"],
            batch_size=tr["batch_size"], patch_size=tuple(tr["patch_size"]),
            num_classes=self.config["num_classes"],
            eval_every=tr["eval_every"], seed=self.seed, snapshot_dir=None,
            bf16=tr["bf16"])
        self.trainer = self._trainer(model, train_cfg)
        _sync(self.device)
        self.parts["trainer_s"] = time.perf_counter() - t
        t = time.perf_counter()
        transform = RandomGenerator(tr["patch_size"], seed=self.seed)
        if self.fault == "altered":
            transform = _altered(transform, self.config["num_classes"])
        dataset = SliceDataset.from_samples(
            [{"image": self.slices["image"][i],
              "label": self.slices["label"][i]}
             for i in range(tr["slices"])], transform=transform)
        self.loader = Loader(dataset, self._sampler(tr["slices"]),
                             device=self.device)
        self.feed = Feed(self.loader)
        if self.fault == "frozen":
            self.trainer.optimizer.step = lambda *a, **k: None
        elif self.fault == "half_batch":
            full = self.trainer.train_step

            def half(batch):
                return full({k: v[:v.shape[0] // 2] for k, v in batch.items()})

            self.trainer.train_step = half
        self.parts["loader_s"] = time.perf_counter() - t

    # --- set-up: the checked steps and the warm-up ------------------------
    def setup(self, warmup: bool = True) -> None:
        self.build()
        trainer, n = self.trainer, self.traffic["checked_steps"]
        losses: List[torch.Tensor] = []
        batches: List[Dict[str, torch.Tensor]] = []
        inner = trainer.__dict__.get("train_step")

        def step(batch):
            batches.append({k: batch[k].cpu() for k in ("image", "label")})
            logs = (inner or type(trainer).train_step.__get__(trainer))(batch)
            losses.append(logs["loss_total"].detach())
            return logs

        def before_fetch(handed: int) -> None:
            if handed == 1:
                opt = trainer.optimizer
                self.readings["grad_norms"] = norms({
                    name: opt.state[p]["momentum_buffer"]
                    for name, p in trainer.model.named_parameters()
                    if "momentum_buffer" in opt.state.get(p, {})})
            if handed == n:
                self._read_after_steps()
                if inner is None:
                    del trainer.train_step
                else:
                    trainer.train_step = inner
                self.feed.before_fetch = None

        trainer.train_step = step
        self.feed.before_fetch = before_fetch
        t = time.perf_counter()
        trainer.fit(self.feed.take(count=n))
        self.readings["losses"] = [float(x) for x in losses]
        self.readings["batches"] = batches
        self.parts["checked_steps_s"] = time.perf_counter() - t
        if warmup:
            t = time.perf_counter()
            trainer.fit(self.feed.take(count=self.traffic["warmup_steps"]))
            _sync(self.device)
            self.parts["warmup_s"] = time.perf_counter() - t

    def _read_after_steps(self) -> None:
        trainer = self.trainer
        p0 = init_weights(self.config, self.seed, self.device)
        params = dict(trainer.model.named_parameters())
        with torch.no_grad():
            self.readings["update_norms"] = norms(
                {n: p - p0[n] for n, p in params.items()})
        del p0

    # --- the window -------------------------------------------------------
    def _fit(self, count: Optional[int] = None,
             seconds: Optional[float] = None) -> float:
        """Host seconds of one ``fit`` over ``count`` batches or for
        ``seconds``, the card synchronised at both ends."""
        _sync(self.device)
        t0 = time.perf_counter()
        self.trainer.fit(self.feed.take(
            count=count, deadline=None if seconds is None else t0 + seconds))
        _sync(self.device)
        return time.perf_counter() - t0

    def _traced_fit(self, count: Optional[int] = None,
                    seconds: Optional[float] = None):
        """(host seconds, reduced trace) of one ``fit`` under
        ``torch.profiler``. On the card the profiler records device
        activity only (kernels, copies and the CUDA calls that issue
        them) and no host operation; it still slows the host's launches,
        which the device's seconds do not depend on."""
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CUDA if self.device.type == "cuda"
                else ProfilerActivity.CPU]
        with profile(activities=acts) as prof:
            window_s = self._fit(count=count, seconds=seconds)
        return window_s, trace.reduce(*trace.events(prof))

    def window(self, seconds: float) -> Dict:
        """Drive ``fit`` for ``seconds`` under the profiler: every step of
        the window, and the seconds in which the card was busy in it."""
        start = self.feed.handed
        window_s, red = self._traced_fit(seconds=seconds)
        steps = self.feed.handed - start
        red.update(window_s=window_s, steps=steps)
        return {"window_s": window_s, "steps": steps,
                "samples": steps * self.traffic["batch_size"], "trace": red}

    def traced_window(self, seconds: float, steps: int) -> Dict:
        """``fit`` for ``seconds`` timed by the host's clock alone, then
        ``steps`` steps under the profiler. The readers that divide by
        the host's time take the untraced stretch (``untraced_s`` over
        ``untraced_steps``), since the profiler slows the host's
        launches; the traced steps give the device's seconds. The
        loader's waits are the untraced steps'."""
        wait0, start = len(self.feed.waits), self.feed.handed
        untraced_s = self._fit(seconds=seconds)
        untraced = self.feed.handed - start
        waits = self.feed.waits[wait0:]
        window_s, red = self._traced_fit(count=steps)
        red.update(window_s=window_s, steps=steps, untraced_s=untraced_s,
                   untraced_steps=untraced, loader_waits=waits)
        total = untraced + steps
        return {"window_s": untraced_s + window_s, "steps": total,
                "samples": total * self.traffic["batch_size"], "trace": red}

    def release(self) -> None:
        """Stop the loader and free the program's state."""
        self.feed.close()
        del self.trainer, self.loader, self.feed
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # --- the reference ----------------------------------------------------
    def reference_batches(self) -> List[Dict[str, torch.Tensor]]:
        """The checked steps' batches, worked out again from the raw
        slices: the sampler's indices and the transform's draws."""
        if self._ref_batches is None:
            tr = self.traffic
            out = ref_data.batches(
                self.slices, self._ref_sampler(tr["slices"]),
                ref_data.Transform(tr["patch_size"], self.seed),
                tr["checked_steps"])
            self._ref_batches = [
                {k: torch.from_numpy(b[k]).to(self.device) for k in b}
                for b in out]
        return self._ref_batches

    def batch_mismatch(self) -> int:
        """Values of the program's fed batches that differ from the
        reference's."""
        ref = self.reference_batches()
        prog = self.readings["batches"]
        if len(prog) != len(ref):
            return 10 ** 12
        bad = 0
        for p, r in zip(prog, ref):
            for k in ("image", "label"):
                a, b = p[k].to(self.device), r[k]
                if k == "label":
                    a = a.long()
                bad += (int((a != b).sum()) if a.shape == b.shape
                        else 10 ** 12)
        return bad

    def reference(self, precision: str = "fp32") -> Dict[str, object]:
        """The reference's readings over the checked steps, computed in
        ``precision`` with TF32 off."""
        matmul, cudnn = (torch.backends.cuda.matmul.allow_tf32,
                         torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        try:
            return method(self.traffic).follow(
                self.config, self.traffic,
                init_weights(self.config, self.seed, self.device),
                self.reference_batches(), self.seed, Precision(precision))
        finally:
            torch.backends.cuda.matmul.allow_tf32 = matmul
            torch.backends.cudnn.allow_tf32 = cudnn


def _altered(transform, num_classes: int):
    def changed(sample):
        out = transform(sample)
        out["label"] = out["label"].copy()
        out["label"][0, 0] = (out["label"][0, 0] + 1) % num_classes
        return out

    return changed
