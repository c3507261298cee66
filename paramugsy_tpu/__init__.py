"""paramugsy_tpu: whole-genome multiple alignment on GPUs with JAX.

A from-scratch framework with the capabilities of paramugsy
(a distributed orchestrator for the Mugsy whole-genome aligner): guide-tree
driven hierarchical alignment of many genomes, pairwise MUM seeding + anchor
chaining + banded extension on-device (JAX), profile
translate/untranslate coordinate algebra for tree-structured merging, and a
complete MAF toolchain.

Layer map (mirrors SURVEY.md section 1 of the reference analysis):

    cli          - user entry point            [ref L7: lib/base/paramugsy.ml]
    tree         - guide tree + job tree       [ref L6: pm_job.ml, mugsy_guide_tree.ml]
    runtime      - executor/scheduler/backends [ref L5/L3/L2]
    lcb          - leaf multi-genome LCB+MSA   [ref L1: mugsyWGA role]
    ops          - on-device alignment kernels [replaces external nucmer/mugsyWGA DP]
    coords       - profile/range/translate     [ref L0: lib/profiles*, lib/m_translate]
    formats      - FASTA/MAF/delta/XMFA IO     [ref L0: lib/maf, lib/fasta]
    tools        - MAF toolchain               [ref aux: mafstat/mafvalidate/...]
    parallel     - mesh + sharding helpers     [ref infra: SGE/rsync -> device collectives]
"""

__version__ = "0.1.0"
