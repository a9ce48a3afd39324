"""Hyperparameter search: generators, score functions, runner.

The counterpart of ``deeplearning4j_tpu/arbiter/optimize.py``.
Reference: org.deeplearning4j.arbiter.optimize — CandidateGenerator
(RandomSearchGenerator, GridSearchCandidateGenerator), ScoreFunction
(TestSetLossScoreFunction, EvaluationScoreFunction), termination conditions
(MaxCandidatesCondition, MaxTimeCondition) and LocalOptimizationRunner.

Design difference from the reference: instead of the MultiLayerSpace config
DSL, a candidate is a plain dict sampled from named ParameterSpaces and the
user supplies `modelBuilder(candidate) -> MultiLayerNetwork/ComputationGraph`.
That keeps the search loop orthogonal to the (already fluent) config builders.
Every draw of a generator comes from ``np.random.RandomState(seed)``, as the
reference's, so one seed gives both packages the same candidates.
"""

from __future__ import annotations

import itertools
import time

from deeplearning4j_tpu_torch.arbiter.spaces import ParameterSpace


# ---------------------------------------------------------------------------
# candidate generators
# ---------------------------------------------------------------------------

class RandomSearchGenerator:
    def __init__(self, parameterSpaces: dict, seed: int = 12345):
        import numpy as np

        for k, v in parameterSpaces.items():
            if not isinstance(v, ParameterSpace):
                raise TypeError(f"space '{k}' is not a ParameterSpace")
        self.spaces = dict(parameterSpaces)
        self._rng = np.random.RandomState(seed)

    def hasMore(self) -> bool:
        return True  # bounded by termination conditions

    def next(self) -> dict:
        return {k: s.sample(self._rng) for k, s in self.spaces.items()}


class GeneticSearchCandidateGenerator:
    """Population-based search (reference: arbiter.optimize.generator.
    GeneticSearchCandidateGenerator + the genetic package's
    ChromosomeFactory / GeneticSelectionOperator / crossover + mutation
    operators). A genome is one unit-interval coordinate per named
    space, decoded through ParameterSpace.from_unit — crossover and
    mutation stay space-agnostic.

    Generation 0 is uniform-random. Breeding: tournament selection over
    every scored individual so far ((mu+lambda)-style — elites persist
    in the parent pool instead of being re-emitted for re-evaluation,
    unlike upstream's explicit elitism, which re-scores survivors),
    uniform crossover, per-gene gaussian mutation. The runner feeds
    scores back through reportResult(); without feedback it degrades to
    random search (a loud degradation: breeding raises)."""

    def __init__(self, parameterSpaces: dict, populationSize: int = 20,
                 crossoverRate: float = 0.85, mutationRate: float = 0.15,
                 mutationStdev: float = 0.15, tournamentSize: int = 3,
                 seed: int = 12345):
        import numpy as np

        for k, v in parameterSpaces.items():
            if not isinstance(v, ParameterSpace):
                raise TypeError(f"space '{k}' is not a ParameterSpace")
        if populationSize < 2:
            raise ValueError("populationSize must be >= 2")
        if tournamentSize < 1:
            raise ValueError("tournamentSize must be >= 1")
        self.spaces = dict(parameterSpaces)
        self._names = list(self.spaces)
        self.populationSize = int(populationSize)
        self.crossoverRate = float(crossoverRate)
        self.mutationRate = float(mutationRate)
        self.mutationStdev = float(mutationStdev)
        self.tournamentSize = int(tournamentSize)
        self._rng = np.random.RandomState(seed)
        self._pending = [self._rng.uniform(size=len(self._names))
                         for _ in range(self.populationSize)]
        self._awaiting = []   # emitted genomes, FIFO, waiting on scores
        self._scored = []     # (genome, fitness) — fitness maximized
        self.generation = 0

    def hasMore(self) -> bool:
        return True  # bounded by termination conditions

    def _decode(self, genome) -> dict:
        return {k: self.spaces[k].from_unit(u)
                for k, u in zip(self._names, genome)}

    def next(self) -> dict:
        if not self._pending:
            self._breed()
        g = self._pending.pop(0)
        self._awaiting.append(g)
        return self._decode(g)

    def reportResult(self, candidate: dict, score: float, minimize: bool):
        """Fitness feedback from the runner, FIFO-paired with next().
        Failed candidates arrive as +/-inf and become -inf fitness."""
        import math as _math

        if not self._awaiting:
            raise RuntimeError("reportResult without an outstanding "
                               "candidate (next() not called?)")
        g = self._awaiting.pop(0)
        if candidate != self._decode(g):
            raise ValueError(
                "reportResult candidate does not match the oldest "
                "outstanding next() candidate — results must be "
                "reported in emission order (FIFO)")
        fit = -score if minimize else score
        if not _math.isfinite(fit):
            fit = float("-inf")
        self._scored.append((g, fit))

    def _breed(self):
        import numpy as np

        if not self._scored:
            raise RuntimeError(
                "GeneticSearchCandidateGenerator needs score feedback to "
                "breed generation 1+ — run it under a runner that calls "
                "reportResult (LocalOptimizationRunner does)")
        rng = self._rng
        n_genes = len(self._names)
        # (mu+lambda) truncation: parents come from the best
        # populationSize individuals EVER scored, not the whole history
        # — tournament over an ever-growing pool dilutes selection
        # pressure to nothing by late generations
        pool = sorted(self._scored, key=lambda gf: gf[1],
                      reverse=True)[:self.populationSize]
        # anneal the mutation step: explore early, refine late
        stdev = self.mutationStdev / (1.0 + 0.3 * self.generation)

        def tournament():
            idx = rng.randint(0, len(pool),
                              size=min(self.tournamentSize, len(pool)))
            best = max(idx, key=lambda i: pool[i][1])
            return pool[best][0]

        offspring = []
        while len(offspring) < self.populationSize:
            a, b = tournament(), tournament()
            if rng.rand() < self.crossoverRate:
                pick = rng.rand(n_genes) < 0.5  # uniform crossover
                child = np.where(pick, a, b).astype(float)
            else:
                child = np.array(a, dtype=float)
            mut = rng.rand(n_genes) < self.mutationRate
            child = child + mut * rng.normal(0.0, stdev, size=n_genes)
            # decode clamps to [0,1]; clamp here too so genomes stay in
            # the unit cube for future crossovers
            offspring.append(np.clip(child, 0.0, 1.0))
        self._pending = offspring
        self.generation += 1


class GridSearchCandidateGenerator:
    def __init__(self, parameterSpaces: dict, discretizationCount: int = 3):
        self.spaces = dict(parameterSpaces)
        axes = [(k, s.grid(discretizationCount)) for k, s in self.spaces.items()]
        names = [k for k, _ in axes]
        self._candidates = [dict(zip(names, combo))
                            for combo in itertools.product(*(vs for _, vs in axes))]
        self._i = 0

    def __len__(self):
        return len(self._candidates)

    def hasMore(self) -> bool:
        return self._i < len(self._candidates)

    def next(self) -> dict:
        c = self._candidates[self._i]
        self._i += 1
        return c


# ---------------------------------------------------------------------------
# score functions
# ---------------------------------------------------------------------------

class TestSetLossScoreFunction:
    """Held-out loss; minimized (reference:
    arbiter.scoring.impl.TestSetLossScoreFunction)."""

    __test__ = False  # not a pytest class despite the Test prefix

    def __init__(self, testData):
        self.testData = testData

    def minimize(self) -> bool:
        return True

    def score(self, model) -> float:
        from deeplearning4j_tpu_torch.optimize.earlystopping import \
            DataSetLossCalculator

        return DataSetLossCalculator(self.testData).calculateScore(model)


class EvaluationScoreFunction:
    """Held-out classification metric; maximized (reference:
    arbiter.scoring.impl.EvaluationScoreFunction)."""

    def __init__(self, testData, metric: str = "accuracy"):
        self.testData = testData
        self.metric = metric

    def minimize(self) -> bool:
        return False

    def score(self, model) -> float:
        e = model.evaluate(self.testData)
        return float(getattr(e, self.metric)())


# ---------------------------------------------------------------------------
# termination conditions
# ---------------------------------------------------------------------------

class MaxCandidatesCondition:
    def __init__(self, maxCandidates: int):
        self.maxCandidates = int(maxCandidates)

    def initialize(self):
        pass

    def terminate(self, numCandidates: int) -> bool:
        return numCandidates >= self.maxCandidates


class MaxTimeCondition:
    def __init__(self, duration: float, unit: str = "seconds"):
        mult = {"seconds": 1.0, "minutes": 60.0, "hours": 3600.0}[unit]
        self.maxSeconds = float(duration) * mult
        self._start = None

    def initialize(self):
        self._start = time.perf_counter()

    def terminate(self, numCandidates: int) -> bool:
        return (time.perf_counter() - self._start) >= self.maxSeconds


# ---------------------------------------------------------------------------
# configuration + runner
# ---------------------------------------------------------------------------

class CandidateResult:
    """One evaluated candidate: its index, hyperparameters, score, the
    trained model (None when it failed) and the exception it raised.
    The model is kept, so every completed candidate's network stays on
    its device until the result is dropped (harmless at LeNet widths;
    a search over large networks should keep only what it needs)."""

    def __init__(self, index, candidate, score, model=None, error=None):
        self.index = index
        self.candidate = candidate
        self.score = score
        self.model = model
        self.error = error

    def __repr__(self):
        return f"CandidateResult(#{self.index}, {self.candidate}, score={self.score})"


class OptimizationResult:
    def __init__(self, best: CandidateResult, results: list):
        self.best = best
        self.results = results

    def bestCandidate(self) -> dict:
        return self.best.candidate

    def bestScore(self) -> float:
        return self.best.score

    def bestModel(self):
        return self.best.model


class OptimizationConfiguration:
    class Builder:
        def __init__(self):
            self._gen = None
            self._score = None
            self._conds = [MaxCandidatesCondition(10)]
            self._epochs = 1

        def candidateGenerator(self, gen):
            self._gen = gen
            return self

        def scoreFunction(self, fn):
            self._score = fn
            return self

        def terminationConditions(self, *conds):
            self._conds = list(conds)
            return self

        def epochsPerCandidate(self, n: int):
            self._epochs = int(n)
            return self

        def build(self):
            if self._gen is None or self._score is None:
                raise ValueError("candidateGenerator and scoreFunction are required")
            return OptimizationConfiguration(self)

    def __init__(self, b):
        self.candidateGenerator = b._gen
        self.scoreFunction = b._score
        self.terminationConditions = b._conds
        self.epochsPerCandidate = b._epochs


class LocalOptimizationRunner:
    """Sequential candidate evaluation on the local device (reference:
    arbiter LocalOptimizationRunner). A failed candidate (any exception
    its build, fit or score raises) records its error and the search
    continues, like the reference's failed-candidate status."""

    def __init__(self, configuration: OptimizationConfiguration, modelBuilder,
                 trainData):
        self.conf = configuration
        self.modelBuilder = modelBuilder
        self.trainData = trainData

    def execute(self) -> OptimizationResult:
        conf = self.conf
        for c in conf.terminationConditions:
            c.initialize()
        results = []
        best = None
        minimize = conf.scoreFunction.minimize()
        n = 0
        while conf.candidateGenerator.hasMore():
            if any(c.terminate(n) for c in conf.terminationConditions):
                break
            candidate = conf.candidateGenerator.next()
            try:
                model = self.modelBuilder(candidate)
                model.fit(self.trainData, epochs=conf.epochsPerCandidate)
                score = conf.scoreFunction.score(model)
                res = CandidateResult(n, candidate, score, model)
            except Exception as e:  # candidate failure != search failure
                res = CandidateResult(n, candidate,
                                      float("inf") if minimize else float("-inf"),
                                      error=e)
            results.append(res)
            if hasattr(conf.candidateGenerator, "reportResult"):
                # feedback-driven generators (genetic) learn from every
                # candidate, including failures (scored +/-inf above)
                conf.candidateGenerator.reportResult(
                    candidate, res.score, minimize)
            if res.error is None and (
                    best is None or
                    (res.score < best.score if minimize else res.score > best.score)):
                best = res
            n += 1
        if best is None:
            raise RuntimeError(
                "no candidate completed successfully; first error: "
                f"{results[0].error if results else 'no candidates generated'}")
        return OptimizationResult(best, results)
