"""SimulEval interop (counterpart of simulst_tpu/stream/simuleval_agent.py):
the port's streaming agents behind SimulEval's `SpeechAgent` contract
(states, policy, predict), so that the tool the reference's published
numbers came from can score the port's models:

    simuleval --agent simulst_tpu_torch/stream/simuleval_agent.py \\
        --model-path ckpt --tgt-splitter-path spm.model --agent-type cif ...

The protocol of the reference's agent (default_agent.py:97-477):
  * `speech_segment_size`: the first READ asks for (segment + rc) x
    stride x 10 ms plus a window shift, each later READ segment x stride
    x 10 ms (stream/agents.chunk_geometry_ms);
  * `segment_to_units` passes raw samples on (the fbank runs in the
    session's OnlineFbank on READ);
  * `policy` drives the step-wise session: MMA / wait-k decide by their
    monotonic heads, CIF compares the fired and the decoded lengths, the
    transducer READs when every visible frame predicts blank;
  * `predict` returns the argmax token id, or None for a rejected early
    EOS (force-finish);
  * `units_to_segment` merges BPE units into words at the "▁" boundary
    and ends with DEFAULT_EOS.

Importable without simuleval: its base class and action constants then
fall back to local stand-ins, so that a mock event loop can hold the
protocol to the built-in evaluator.  The model runs on the card unless
--device names another.
"""
from __future__ import annotations

from typing import List

import numpy as np

try:  # pragma: no cover - only where simuleval is installed
    from simuleval import DEFAULT_EOS, READ_ACTION, WRITE_ACTION
    from simuleval.agents import SpeechAgent as _SimulEvalSpeechAgent
    HAVE_SIMULEVAL = True
except Exception:  # simuleval absent: local stand-ins of its protocol
    READ_ACTION, WRITE_ACTION = "get", "send"
    DEFAULT_EOS = "</s>"
    HAVE_SIMULEVAL = False

    class _SimulEvalSpeechAgent:  # the base's constructor keeps the args
        data_type = "speech"

        def __init__(self, args):
            self.args = args

from simulst_tpu_torch.data.vocab import EOS
from simulst_tpu_torch.stream.agents import BOW_PREFIX, READ, chunk_geometry_ms
from simulst_tpu_torch.stream.build import build_agent, load_vocab


class SimulSTAgent(_SimulEvalSpeechAgent):
    """SimulEval SpeechAgent over a step-wise simulst_tpu_torch session."""

    data_type = "speech"
    speech_segment_size = 640  # set from the model in __init__

    @staticmethod
    def add_args(parser):
        parser.add_argument("--model-path", type=str, required=True,
                            help="a checkpoint of simulst_tpu_torch.cli.train")
        parser.add_argument("--tgt-splitter-path", type=str, required=True,
                            help="target vocabulary (.model SPM or .txt)")
        parser.add_argument("--agent-type", type=str, default="mma",
                            choices=["mma", "waitk", "cif", "transducer"])
        parser.add_argument("--model", type=str, default=None,
                            help="model registry name override")
        parser.add_argument("--global-stats", type=str, default=None,
                            help="npz with global CMVN mean/std")
        parser.add_argument("--waitk", type=int, default=None,
                            help="test-time wait-k lagging")
        parser.add_argument("--cif-beta", type=float, default=None,
                            help="test-time CIF beta recalibration")
        parser.add_argument("--overshoot-weight", type=float, default=1.0)
        parser.add_argument("--force-finish", default=False,
                            action="store_true")
        parser.add_argument("--max-len-a", type=float, default=1)
        parser.add_argument("--max-len-b", type=int, default=0)
        parser.add_argument("--device", type=str, default=None,
                            help="torch device (default: the card, cuda)")
        return parser

    def __init__(self, args):
        super().__init__(args)
        self.vocab = load_vocab(args.tgt_splitter_path)
        self.agent = build_agent(
            args.model_path, self.vocab, agent_type=args.agent_type,
            model_name=getattr(args, "model", None),
            waitk=getattr(args, "waitk", None),
            cif_beta=getattr(args, "cif_beta", None),
            overshoot_weight=getattr(args, "overshoot_weight", 1.0),
            global_cmvn_path=getattr(args, "global_stats", None),
            device=getattr(args, "device", None))
        self.agent.acfg.force_finish = bool(getattr(args, "force_finish",
                                                    False))
        first_ms, steady_ms = chunk_geometry_ms(self.agent.cfg)
        self.first_segment_size = first_ms
        self.steady_segment_size = steady_ms
        self.speech_segment_size = first_ms
        a, b = getattr(args, "max_len_a", 1), getattr(args, "max_len_b", 0)
        self.max_len = lambda src_units: a * src_units + b

    # -- SimulEval protocol --------------------------------------------------

    def initialize_states(self, states):
        states.session = self.agent.new_session()
        states.pending_samples: List[np.ndarray] = []
        self.speech_segment_size = self.first_segment_size

    def build_states(self, args, client, sentence_id):
        # called by simuleval only (SpeechStates lives there)
        from simuleval.states import SpeechStates
        states = SpeechStates(args, client, sentence_id, self)
        self.initialize_states(states)
        return states

    def segment_to_units(self, segment, states):
        """Raw samples pass as one unit: the fbank and CMVN run in the
        session's OnlineFbank on READ."""
        samples = np.asarray(segment, np.float32)
        if samples.size == 0:
            return []
        states.pending_samples.append(samples)
        return [samples]

    def update_states_read(self, states):
        if not states.pending_samples and not states.finish_read():
            return
        samples = (np.concatenate(states.pending_samples)
                   if states.pending_samples
                   else np.zeros((0,), np.float32))
        states.pending_samples = []
        states.session.push_audio(samples, finished=states.finish_read())

    def policy(self, states):
        session = states.session
        if not session._got_first:
            if states.finish_read():
                # the source ended before one whole first chunk
                self.update_states_read(states)
            else:
                self.speech_segment_size = self.first_segment_size
                return READ_ACTION
        if session.finished:
            return WRITE_ACTION  # drain: predict() gives EOS
        if session.policy() == READ:
            self.speech_segment_size = self.steady_segment_size
            return READ_ACTION
        return WRITE_ACTION

    def predict(self, states):
        session = states.session
        if session.finished:
            return EOS  # EOS written, or the length cap reached
        return session.predict()  # None: a rejected early EOS

    def units_to_segment(self, unit_queue, states):
        """BPE ids -> whole words (the reference's :241-301)."""
        units = list(getattr(unit_queue, "value", unit_queue))
        if not units:
            return None
        if units[0] == EOS:
            return DEFAULT_EOS
        if None in units:
            unit_queue.value.remove(None)
            units = [u for u in units if u is not None]
            if not units:
                return None

        src_units = len(states.units.source)
        if (units and units[-1] == EOS) or \
                len(states.units.target) > self.max_len(src_units):
            toks = [self.vocab.symbols[u] for u in units if u != EOS]
            hyp = "".join(toks).replace(BOW_PREFIX, " ").strip()
            return [hyp] + [DEFAULT_EOS]

        segment = []
        for u in units:
            token = self.vocab.symbols[u]
            if token.startswith(BOW_PREFIX):
                if len(segment) == 0:
                    segment.append(token[len(BOW_PREFIX):])
                else:
                    for _ in range(len(segment)):
                        unit_queue.pop()
                    out = ["".join(segment)]
                    if list(getattr(unit_queue, "value", unit_queue))[0] \
                            == EOS:
                        out.append(DEFAULT_EOS)
                    return out
            else:
                segment.append(token.replace(BOW_PREFIX, ""))
        return None
