"""The port's MEME against the JAX package's with the options a K = 2 run
leaves out: three rate classes, background branches (four of the six
leaves tested) and ``--multiple-hits Double`` with per-site 2H rates; the
JAX run's GTR and MG94 fits carried across.  The fixture and the table
comparison are ``tests/test_torch_meme.py``'s."""

import numpy as np
import torch

from test_torch_meme import PLANTED, assert_tables_match, run_both, write_fixture

torch.set_num_threads(2)


def test_meme_k3_background_double_hits_match(tmp_path):
    fasta, newick = write_fixture(tmp_path)
    ours, ref = run_both(fasta, newick, rate_classes=3, branches="t0,t1,t2,t3",
                         multiple_hits="Double")
    assert (~ours.data.tested_branches).any()
    calls = assert_tables_match(ours, ref, 3)
    names = [h[0] for h in ours.headers]
    assert names[-1] == "2H rate"
    np.testing.assert_allclose(ours.site_table[:, -1], ref.site_table[:, -1], rtol=0, atol=0.15)
    # a planted site is called
    assert calls[list(PLANTED)].any()
