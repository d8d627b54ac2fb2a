"""Host-side (numpy) data preparation: the nuScenes dataset and loader,
the submission writer and scorer, and the chunked layout's topology tables."""
