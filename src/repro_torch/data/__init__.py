"""The training data pipeline (numpy only): a synthetic Zipfian corpus,
a flat token file, and the deterministic sharded batch stream."""

from .pipeline import SyntheticCorpus, FileCorpus, DataPipeline

__all__ = ["SyntheticCorpus", "FileCorpus", "DataPipeline"]
