"""Experiment harness: multi-model tracking, grid search, classical baselines.

Counterpart of the reference's experiment tooling
(lib/utils.py:223-332): ``ModelPerf`` runs fit+evaluate and tabulates
results across named models, ``grid_search`` sweeps hyper-parameter grids,
and ``baseline`` pits the graph nets against classical sklearn classifiers.
"""

from __future__ import annotations

import itertools
import time
from typing import Callable

import numpy as np

__all__ = ["ModelPerf", "grid_search", "baseline"]


class ModelPerf:
    """Track fit/eval results across models (lib/utils.py:278-332).

    ``test`` runs ``trainer.fit`` + train/test evaluation and stores
    histories; ``show`` prints the comparison table.  Matplotlib convergence
    plots are available via ``plot`` when matplotlib is installed.
    """

    def __init__(self):
        self.names = []
        self.params = {}
        self.fit_histories = {}
        self.fit_losses = {}
        self.fit_time = {}
        self.train_metrics = {}
        self.test_metrics = {}

    def test(self, trainer, name, params, train_data, train_labels,
             val_data, val_labels, test_data, test_labels):
        self.params[name] = params
        hist, losses, t_step = trainer.fit(
            train_data, train_labels, val_data, val_labels
        )
        self.fit_histories[name] = hist
        self.fit_losses[name] = losses
        self.fit_time[name] = t_step

        string, train_m = trainer.evaluate(train_data, train_labels)
        print(f"train {string}")
        string, test_m = trainer.evaluate(test_data, test_labels)
        print(f"test  {string}")
        self.train_metrics[name] = train_m
        self.test_metrics[name] = test_m
        if name not in self.names:
            self.names.append(name)
        return train_m.get("predictions"), test_m.get("predictions")

    def show(self):
        print("  main metric     loss            time [ms]  name")
        print(" test  train   test      train")
        for name in sorted(self.names):
            tr, te = self.train_metrics[name], self.test_metrics[name]
            print(
                f"{te['main']:5.2f} {tr['main']:5.2f}   "
                f"{te['loss']:.2e} {tr['loss']:.2e}   "
                f"{self.fit_time[name] * 1000:4.0f}   {name}"
            )

    def plot(self, eval_frequency: int = 1):
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(1, 2, figsize=(15, 5))
        for name in sorted(self.names):
            steps = (np.arange(len(self.fit_histories[name])) + 1) * eval_frequency
            ax[0].plot(steps, self.fit_histories[name], ".-", label=name)
            ax[1].plot(steps, self.fit_losses[name], ".-", label=name)
        ax[0].set_xlabel("step"), ax[0].set_ylabel("validation metric")
        ax[1].set_xlabel("step"), ax[1].set_ylabel("validation loss")
        ax[0].legend(loc="lower right"), ax[1].legend(loc="upper right")
        return fig


def grid_search(grid_params: dict, make_trainer: Callable, train_data,
                train_labels, val_data, val_labels, test_data, test_labels):
    """Exhaustive sweep over the cartesian product of ``grid_params``
    (lib/utils.py:250-275; nips2016/gconvTest.py:82-111).  Each combo calls
    ``make_trainer(**combo)``; failures are caught per-trial so one bad
    config doesn't kill the grid (gconvTest.py:113-114).  Returns a list of
    ``(combo, test_metrics | None)``."""
    keys = list(grid_params)
    results = []
    combos = list(itertools.product(*(grid_params[k] for k in keys)))
    print(f"grid search: {len(combos)} combinations to evaluate")
    for values in combos:
        combo = dict(zip(keys, values))
        print(f"\n  {combo}\n")
        try:
            trainer = make_trainer(**combo)
            trainer.fit(train_data, train_labels, val_data, val_labels)
            string, metrics = trainer.evaluate(test_data, test_labels)
            print(f"test  {string}")
            results.append((combo, metrics))
        except Exception as e:  # per-trial isolation, gconvTest.py:185-187
            print(f"  FAILED: {type(e).__name__}: {e}")
            results.append((combo, None))
    for combo, metrics in results:
        main = f"{metrics['main']:.4f}" if metrics else "failed"
        print(f"{combo} --> {main}")
    return results


def baseline(train_data, train_labels, test_data, test_labels, omit=()):
    """Classical-classifier baselines (lib/utils.py:223-248): kNN, logistic
    regression, Bernoulli/multinomial NB, random forest, ridge, linear SVC —
    accuracy, weighted F1 and fit time on the same split."""
    import sklearn.ensemble
    import sklearn.linear_model
    import sklearn.metrics
    import sklearn.naive_bayes
    import sklearn.neighbors
    import sklearn.svm

    classifiers = [
        sklearn.neighbors.KNeighborsClassifier(n_neighbors=10),
        sklearn.linear_model.LogisticRegression(max_iter=1000),
        sklearn.naive_bayes.BernoulliNB(alpha=0.01),
        sklearn.ensemble.RandomForestClassifier(),
        sklearn.naive_bayes.MultinomialNB(alpha=0.01),
        sklearn.linear_model.RidgeClassifier(),
        sklearn.svm.LinearSVC(),
    ]
    rows = []
    for i, clf in enumerate(classifiers):
        if i in omit:
            continue
        t0 = time.process_time()
        clf.fit(train_data, train_labels)
        train_pred = clf.predict(train_data)
        test_pred = clf.predict(test_data)
        rows.append(
            {
                "name": type(clf).__name__,
                "train_accuracy": 100 * sklearn.metrics.accuracy_score(train_labels, train_pred),
                "test_accuracy": 100 * sklearn.metrics.accuracy_score(test_labels, test_pred),
                "train_f1": 100 * sklearn.metrics.f1_score(train_labels, train_pred, average="weighted"),
                "test_f1": 100 * sklearn.metrics.f1_score(test_labels, test_pred, average="weighted"),
                "time": time.process_time() - t0,
            }
        )
    for key, label in [
        ("train_accuracy", "Train accuracy:     "),
        ("test_accuracy", "Test accuracy:      "),
        ("train_f1", "Train F1 (weighted):"),
        ("test_f1", "Test F1 (weighted): "),
        ("time", "Execution time:     "),
    ]:
        print(label + " ".join(f"{r[key]:5.2f}" for r in rows))
    return rows
