"""The paper's evaluation as entry points of the port: one module per
table or figure of the repo's ``benchmarks/`` scripts, and the roofline
report over the dry run's records::

    python -m repro_torch.reports                       # all, on the card
    python -m repro_torch.reports table2 fig5           # some
    python -m repro_torch.reports table1 --device cpu   # Table 1 on the CPU

Each module's ``main()`` prints its script's lines; ``rows()`` returns
its rows where the script has them. Tables 2 and 4 and Figures 4 and 5
are the cycle model's arithmetic on the host: MODELED cycles of the
paper's 65 nm designs, and each says so in a line of its own. Table 1
runs the profiling method live on ``device`` (the card unless the caller
asks for the CPU). The roofline report reads the records of
``python -m repro_torch.launch.dryrun``, whose times are MODELED on the
H100's datasheet constants. The kernel benchmark is not here yet.
"""

MODELED = ("(MODELED: cycles of the paper's 65 nm DPNN, Stripes and Loom "
           "designs from the cycle model, not a measurement)")
