"""Gradient sync across data-parallel ranks: the MXDAG plan (``plan``)
and the layer-wise overlapped collectives that realize it (``overlap``)."""
