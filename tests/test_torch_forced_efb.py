"""Forced splits on an EFB-bundled table in whole trainings of the port, on
the CPU, against ``lightgbm_tpu.train`` (tests/test_torch_cegb_train.py's
tolerance tier and tests/torch_forced_cegb_helpers.py's pair; a file of its
own so that each file of the training cases stays under a minute): a
forced JSON whose root is a dense column and whose three nodes under it are
one-hot columns of one bundle, with a coupled CEGB penalty, so that the
forced record reads decoded bundle rows and the pick wires them. The model
text equal but for the gains (within rtol 1e-5), the CEGB state equal, the
forced nodes first in every tree.
"""
import json

from torch_forced_cegb_helpers import BASE, device_loop, efb_table, one_torch_thread  # noqa: F401
from torch_forced_cegb_helpers import same_models, same_state, train_both


def test_efb_with_forced_splits(device_loop, tmp_path):
    X, y = efb_table(8)
    fs = tmp_path / "forced.json"
    fs.write_text(json.dumps({"feature": 0, "threshold": 0.0,
                              "left": {"feature": 3, "threshold": 0.5,
                                       "left": {"feature": 5, "threshold": 0.5}},
                              "right": {"feature": 2, "threshold": 0.5}}))
    params = dict(BASE, forcedsplits_filename=str(fs), cegb_penalty_feature_coupled=[1.0] * 14,
                  max_conflict_rate=0.0)
    jb, tb = train_both(params, X, y, 3)
    g = tb._gbdt
    assert g.num_groups > 0 and len(g._forced_splits) == 4
    gid = g.train_set.group_id
    assert len({int(gid[f]) for _, f, _ in g._forced_splits[1:]}) == 1  # one bundle
    same_models(jb, tb)
    same_state(jb, tb)
    for ta in g._tree_arrays:
        assert ta.split_feature[:4].tolist() == [0, 3, 2, 5]
