"""Host-side data preparation: the nuScenes dataset and loader (numpy, and
the host C++ library of `native.py`), the info-pkl builder, the submission
writer and scorer, and the chunked layout's topology tables."""
