"""Offline preprocessing: VisDial JSON filtering, region-feature TSV to a
GSTF store, the counter-fitted cosine-similarity matrix and CLIP in-domain
filtering (the port of ``gstx/preprocessing``)."""
