"""Compressed-domain analytics in PyTorch, counterpart of
``repro.analytics``: aggregates (min/max/sum/mean/count/stddev), range
predicates (``count_where``) and top-k segment queries straight off SHRK
archives and SHRKS containers.  Every answer is an interval ``[lo, hi]``
that contains the decode-then-numpy truth; a refine loop pays pyramid
layers only for frames whose bounds still straddle the query.  The
per-segment algebra runs on the card (the ``segment_agg`` kernel).
"""
from .engine import AggregateAnswer, SeriesAnalytics  # noqa: F401
from .planner import AnalyticsEngine  # noqa: F401
