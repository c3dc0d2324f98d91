"""Pre/post-processing command-line tools (reference L8 equivalents), the
port's own copies of hammlet_tpu/tools (numpy only; their wrappers are
bin/hammlet-torch-*, which import no JAX):

- avg: windowed-mean downsampling of a value stream
- max-segmentation: marginals CSV -> maximum-posterior segmentation
- sort-states: order states by last-iteration emission means
- combine-counts: add/subtract per-position genome count files
- map-lines-to-genome: join output lines back onto genomic coordinates
- sam-to-counts: SAM/BAM -> read-start count files
- plot-results: panel plots of data/marginals/sequences/blocks
"""
