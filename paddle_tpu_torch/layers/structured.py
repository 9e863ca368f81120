"""Structured-prediction layers (the port's part of
``paddle_tpu/layers/structured.py``): ``beam_search`` and
``beam_search_decode``.  The module's other layers (CRF, NCE's layer,
sampled softmax, ``sampling_id``) wait for a later slice (ROADMAP)."""

from __future__ import annotations

from ..layer_helper import LayerHelper


def beam_search(pre_ids, pre_scores, ids, scores, beam_size, end_id,
                level=0, is_accumulated=True, name=None,
                return_parent_idx=True):
    """One decode step (ref ``paddle_tpu/layers/structured.py:208``,
    beam_search_op).  Rows are ``batch * beam_size`` hypothesis slots;
    seed step 0 with ``pre_scores`` 0 for beam 0 and a large negative for
    the rest.  Returns (selected_ids, selected_scores, parent_idx)."""
    helper = LayerHelper("beam_search")
    sel_ids = helper.create_variable_for_type_inference("int64")
    sel_scores = helper.create_variable_for_type_inference(
        pre_scores.dtype)
    parent = helper.create_variable_for_type_inference("int64")
    ins = {"pre_ids": [pre_ids], "pre_scores": [pre_scores],
           "scores": [scores]}
    if ids is not None:
        ins["ids"] = [ids]
    helper.append_op("beam_search", inputs=ins,
                     outputs={"selected_ids": [sel_ids],
                              "selected_scores": [sel_scores],
                              "parent_idx": [parent]},
                     attrs={"beam_size": beam_size, "end_id": end_id,
                            "level": level, "is_accumulated": is_accumulated})
    if return_parent_idx:
        return sel_ids, sel_scores, parent
    return sel_ids, sel_scores


def beam_search_decode(ids, scores, parents, beam_size, end_id, name=None):
    """Backtrack stacked steps ``[time, batch * beam(, 1)]`` into
    sentences (ref ``paddle_tpu/layers/structured.py:238``,
    beam_search_decode_op): (sentence_ids, sentence_scores), each
    ``[batch, beam, time]``."""
    helper = LayerHelper("beam_search_decode")
    sent_ids = helper.create_variable_for_type_inference("int64")
    sent_scores = helper.create_variable_for_type_inference(scores.dtype)
    helper.append_op("beam_search_decode",
                     inputs={"Ids": [ids], "Scores": [scores],
                             "Parents": [parents]},
                     outputs={"SentenceIds": [sent_ids],
                              "SentenceScores": [sent_scores]},
                     attrs={"beam_size": beam_size, "end_id": end_id})
    return sent_ids, sent_scores
