"""Hyperparameter / sampler optimization.

Port of ``calodiffusion_tpu/train/optimize.py`` (reference:
calodiffusion/train/optimize.py): config ranges under ``config["OPTIMIZE"]``
(including the U-Net sizing dict and per-sampler hyperparameter spaces) are
suggested per trial, a model is trained without checkpointing, and one or
more objectives (COUNT speed ratio, FPD fidelity, CNN log-posterior) are
reported to a multi-objective study.

The suggestions are plain Python and the same as the JAX package's.  optuna
is imported lazily and used where installed; where it is not, a random
search with optuna's ``suggest_*`` protocol runs (``_RandomStudy``, seeded
``np.random.default_rng(0)``).  The optuna branch is untested: neither the
CPU test machine nor the card has optuna.  The random study writes its
``{study_name}_report.json`` (keys ``number``, ``params``, ``values``, each
a list over the trials, appended to the file) without pandas; an optuna
study's report goes through its ``trials_dataframe``, which needs pandas.

A trial trains with the port's trainers (``trainer.train()`` returns the
model) and scores the model with its ``inference_weights()`` loaded: the
SWA average, else the EMA, else the raw weights.
"""

from __future__ import annotations

import json
import os
from abc import ABC, abstractmethod
from collections import defaultdict
from datetime import datetime
from typing import Iterable, Literal, Sequence

import numpy as np
import torch

from calodiffusion_tpu_torch.utils.config import LoadJson


# ---------------------------------------------------------------------------
# optuna fallback: random search with the optuna Trial suggest_* protocol
# ---------------------------------------------------------------------------

class _RandomTrial:
    def __init__(self, rng: np.random.Generator, number: int):
        self.rng = rng
        self.number = number
        self.params: dict = {}

    def suggest_int(self, name, low, high, step=1):
        v = int(self.rng.integers(low, high + 1))
        if step > 1:
            v = low + ((v - low) // step) * step
        self.params[name] = v
        return v

    def suggest_float(self, name, low, high):
        v = float(self.rng.uniform(low, high))
        self.params[name] = v
        return v

    def suggest_categorical(self, name, choices):
        v = choices[int(self.rng.integers(len(choices)))]
        self.params[name] = v
        return v


class _RandomStudy:
    """Minimal multi-objective random-search study."""

    def __init__(self, study_name, directions):
        self.study_name = study_name
        self.directions = directions
        self.trials: list[dict] = []

    def optimize(self, objective, n_trials=10, timeout=None):
        rng = np.random.default_rng(0)
        start = datetime.now()
        for i in range(n_trials):
            if timeout and (datetime.now() - start).total_seconds() > timeout:
                break
            trial = _RandomTrial(rng, i)
            try:
                values = objective(trial)
            except Exception as e:  # failed trial
                values = None
                print(f"trial {i} failed: {e}")
            self.trials.append(
                {"number": i, "params": trial.params, "values": values}
            )

    def report(self) -> dict:
        """The trials column by column, as the JAX package's pandas
        ``trials_dataframe`` gives them to its report."""
        if not self.trials:
            return {}
        return {k: [t[k] for t in self.trials] for k in ("number", "params", "values")}


def _create_study(study_name, directions):
    try:
        import optuna

        return optuna.create_study(
            study_name=study_name, load_if_exists=True, directions=directions
        )
    except ImportError:
        print("optuna not available; falling back to random search")
        return _RandomStudy(study_name, directions)


# ---------------------------------------------------------------------------
# objectives (reference optimize.py:228-335)
# ---------------------------------------------------------------------------

def _generator(model) -> torch.Generator:
    """The sampling generator of an objective: seed 0 on the model's device
    (the JAX objectives sample from ``jax.random.PRNGKey(0)``)."""
    return torch.Generator(device=model.device).manual_seed(0)


class Objective(ABC):
    @staticmethod
    @abstractmethod
    def direction() -> Literal["minimize", "maximize"]:
        raise NotImplementedError

    @staticmethod
    @abstractmethod
    def failure() -> float:
        raise NotImplementedError

    def __call__(self, trained_model, eval_data, config) -> float:
        raise NotImplementedError


class Count(Objective):
    """Generation wall-clock normalized by a reference 24x24 product
    (reference :245-293 - the repo's only speed metric).  ``generate``
    returns numpy showers, copied from the card, so the clock stops after
    the card has finished."""

    @staticmethod
    def direction():
        return "minimize"

    @staticmethod
    def failure():
        return 10e8

    def __call__(self, trained_model, eval_data, config) -> float:
        rng = np.random.default_rng()
        a = rng.random((24, 24))
        b = rng.random((24, 24))

        start = datetime.now()
        trained_model.generate(
            eval_data, sample_steps=config["NSTEPS"],
            generator=_generator(trained_model), sample_offset=0,
        )
        inference_time = (datetime.now() - start).total_seconds()

        start = datetime.now()
        a * b
        reference_time = max(
            (datetime.now() - start).total_seconds(), 1e-9
        )
        return inference_time / reference_time


class FPD(Objective):
    @staticmethod
    def direction():
        return "minimize"

    @staticmethod
    def failure():
        return 10e8

    def __call__(self, trained_model, eval_data, config) -> float:
        from calodiffusion_tpu_torch.evaluation import evaluate

        binning = trained_model.config.get("BIN_FILE", "binning_dataset.xml")
        particle = trained_model.config.get("PART_TYPE", "photon")
        fpd_calc = evaluate.FPD(binning, particle)
        try:
            return fpd_calc(trained_model, eval_data, generator=_generator(trained_model))
        except evaluate.FDPCalculationError:
            return FPD.failure()


class CNNMetric(Objective):
    @staticmethod
    def direction():
        return "maximize"

    @staticmethod
    def failure():
        return 1

    def __call__(self, trained_model, eval_data, config) -> float:
        from calodiffusion_tpu_torch.evaluation import evaluate

        cnn = evaluate.CNNCompare(
            trained_model=trained_model, config=config, flags=config.get("flags"),
        )
        return cnn(eval_data)


# ---------------------------------------------------------------------------
# the optimizer
# ---------------------------------------------------------------------------

class Optimize:
    """``trainer`` is the port's ``TrainDiffusion`` or ``TrainLayerModel``;
    it trains on ``flags.device`` (default: the card)."""

    def __init__(self, flags, trainer, objectives) -> None:
        implemented: dict[str, Objective] = {
            "COUNT": Count(),
            "FPD": FPD(),
            "CNN": CNNMetric(),
        }
        self.flags = flags
        self.trainer = trainer
        if isinstance(objectives, str):
            objectives = [objectives]
        self.objectives = [implemented[o] for o in objectives]

    # -- config suggestion (reference :72-180) -------------------------------
    def suggest_config(self, trial):
        if isinstance(self.flags.config, str):
            config = LoadJson(self.flags.config)
        else:
            config = dict(self.flags.config)

        optimized = config.get("OPTIMIZE", {})
        for key, values in optimized.items():
            if not isinstance(values, Iterable):
                raise ValueError(
                    "All optimization parameters must be given as a list."
                )
            if key == "LAYER_SIZE_UNET":
                init_size = trial.suggest_int(
                    "init_unet", *values["init_unet"], step=2
                )
                n_layers = trial.suggest_int(
                    "n_unet_layers", *values["n_unet_layers"]
                )
                final = int(
                    trial.suggest_int("layer_ratio", *values["layer_ratio"])
                    * init_size
                )
                config[key] = [init_size] * n_layers + [final]
                config["BLOCK_GROUPS"] = int(init_size / 2)
            elif key not in ("SAMPLER", "SAMPLER_SETTINGS"):
                if all(isinstance(i, str) for i in values) or (True in values):
                    config[key] = trial.suggest_categorical(key, values)
                elif all(isinstance(i, int) for i in values):
                    config[key] = trial.suggest_int(key, *values)
                else:
                    config[key] = trial.suggest_float(key, *values)
            else:
                config = self.suggest_sampler_config(config, trial)
        return config

    def _suggest(self, name, out, settings, trial, type_=float):
        if name in settings:
            if type_ is float:
                out[name] = trial.suggest_float(name, *settings[name])
            elif type_ is int:
                out[name] = trial.suggest_int(name, *settings[name])
            else:
                out[name] = trial.suggest_categorical(name, settings[name])
        return out

    def suggest_sampler_config(self, config, trial):
        optimized = config.get("OPTIMIZE", {})
        sampler = config.get("SAMPLER")
        if not sampler:
            sampler = trial.suggest_categorical(
                "SAMPLER", optimized.get("SAMPLER", [])
            )
            config["SAMPLER"] = sampler

        sc = defaultdict(dict)
        ss = optimized.get("SAMPLER_SETTINGS", {})

        if sampler in ["DPM", "DPMPPSDE", "DPMPP2S", "DPMPP2MSDE",
                       "DPMAdaptive", "DPMPP3MSDE", "Restart"]:
            sc = self._suggest("ETA", sc, ss, trial)
            sc = self._suggest("S_NOISE", sc, ss, trial)
        if sampler == "DPMAdaptive":
            sc = self._suggest("ORDER", sc, ss, trial, type_=int)
            for s in ["R_TOL", "A_TOL", "H_INIT", "T_ERROR", "ACCEPT_SAFETY"]:
                sc = self._suggest(s, sc, ss, trial)
        if sampler == "DPMPPSDE":
            sc = self._suggest("R", sc, ss, trial)
        if sampler == "DPMPP2MSDE":
            sc = self._suggest("SOLVER", sc, ss, trial, type_=str)
        if sampler in ["LMS", "Euler", "Heun", "DPM2", "Restart"]:
            sc = self._suggest("NOISY_SAMPLE", sc, ss, trial, type_=str)
            sc = self._suggest("ORIG_SCHEDULE", sc, ss, trial, type_=str)
            if sc.get("ORIG_SCHEDULE", True):
                sc = self._suggest("C1", sc, ss, trial)
            sc = self._suggest("RHO", sc, ss, trial, type_=int)
            sc = self._suggest("SIGMA_MIN", sc, ss, trial)
            if sampler in ["Euler", "Heun", "DPM2", "Restart"]:
                for s in ["S_MIN", "S_MAX", "S_NOISE", "S_CHURN"]:
                    sc = self._suggest(s, sc, ss, trial)
        if sampler == "LMS":
            sc = self._suggest("ORDER", sc, ss, trial, type_=int)
        if sampler == "Restart":
            sc = self._suggest("RESTART_GAMMA", sc, ss, trial)
            sc = self._suggest("C2", sc, ss, trial)
            sc = self._suggest("RESTART_I", sc, ss, trial, type_=int)
            sc = self._suggest("N_RESTART", sc, ss, trial, type_=int)
            n_restart = sc.get("N_RESTART", 4)
            restart_settings = {}
            for num in range(sc.get("RESTART_I", 4)):
                k_i = trial.suggest_int(
                    f"RESTART_K_{num}", *ss.get("RESTART_K", [1, 10])
                )
                t_range = ss.get("RESTART_T", [0.01, 50])
                t_min = trial.suggest_float(f"RESTART_T_MIN_{num}", *t_range)
                t_max = trial.suggest_float(
                    f"RESTART_T_MAX_{num}", t_min, t_min + t_range[-1]
                )
                restart_settings[str(num)] = [n_restart, k_i, t_min, t_max]
            sc["RESTART_LIST"] = restart_settings
        # sampler options live under SAMPLER_OPTIONS at runtime; keep the
        # reference's SAMPLER_SETTINGS key for report compatibility
        config["SAMPLER_SETTINGS"] = dict(sc)
        config["SAMPLER_OPTIONS"] = dict(sc)
        return config

    # -- driving -------------------------------------------------------------
    def train(self, trial):
        config = self.suggest_config(trial)
        trainer = self.trainer(flags=self.flags, config=config, save_model=False,
                               device=getattr(self.flags, "device", None))
        model = trainer.train()
        model.load_state_dict(trainer.inference_weights())
        return model, trainer.loader_val, config

    def eval(self, model, eval_data, config) -> Sequence:
        config["flags"] = self.flags
        return [obj(model, eval_data, config) for obj in self.objectives]

    def objective(self, trial) -> tuple:
        try:
            model, eval_data, config = self.train(trial)
        except (RuntimeError, ValueError) as err:
            print(f"trial failed during training: {err}")
            return [obj.failure() for obj in self.objectives]
        return self.eval(model, eval_data, config)

    def save_results(self, study):
        if isinstance(study, _RandomStudy):
            study_results = study.report()
        else:  # optuna: its dataframe needs pandas
            df = study.trials_dataframe()
            study_results = {k: list(v) for k, v in dict(df).items()}
        save_loc = self.flags.results_folder
        os.makedirs(save_loc, exist_ok=True)
        path = f"{save_loc.rstrip('/')}/{self.flags.study_name}_report.json"
        with open(path, "a") as f:
            json.dump(study_results, f, default=str)

    def __call__(self):
        """Run the study; returns it."""
        study = _create_study(
            self.flags.study_name,
            [obj.direction() for obj in self.objectives],
        )
        # no timeout unless the user asks (the reference has none either,
        # optimize.py:214-225); --timeout caps total study wall-clock
        study.optimize(
            self.objective, n_trials=self.flags.n_trials,
            timeout=getattr(self.flags, "timeout", None),
        )
        self.save_results(study)
        return study
