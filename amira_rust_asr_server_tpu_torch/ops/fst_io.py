"""OpenFST text-format importer for decoding graphs (port of ops/fst_io.py,
numpy on the host; the reference module imports jax through ``.beam``).

Capability parity with the reference's k2 backend, which loads a compiled
decoding-graph FST from ``DECODING_GRAPH_PATH`` and intersects it with the
lattice (ref: src/triton_backends/k2_decoder/k2_decoder_backend.cc:96-117).
The equivalent here is a dense, device-resident
:class:`~.beam.TokenTrie` table; this module turns a standard AT&T/OpenFST
*text* FST (what ``fstprint`` emits / ``fstcompile`` consumes) into one:

    src dst ilabel [olabel] [weight]     # arc line
    state [weight]                       # final-state line

Start state = source state of the first line. Weights are tropical COSTS
(lower is better); ``TokenTrie`` stores additive log-probs (higher is
better), so the importer negates them.

The dense table needs a *deterministic, epsilon-free* acceptor over token
ids, while a real decoding graph is usually neither — so the importer runs
exact epsilon-removal + weighted subset construction over the tropical
(max,+) semiring: each DFA subset carries per-NFA-state residual weights,
the best (max) weight is pushed onto the DFA arc, and residuals keep
subset identity exact. For Viterbi/beam decoding (best path) this
preserves every path's total weight exactly.

Labels: by default arc ilabels ARE token ids (and there is no epsilon).
With a symbol table (OpenFST ``symbol<space>id`` lines) labels are mapped
symbol -> vocab token id, and the ``<eps>``/``<epsilon>`` symbol (or raw
id 0, the OpenFST convention) becomes an epsilon transition.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from .beam import TokenTrie

NEG_INF = float("-inf")

# guardrail on subset-construction blowup (a pathological NFA can be
# exponential; real lexicon/grammar graphs are near-deterministic already)
MAX_DFA_STATES = 200_000


class FstFormatError(ValueError):
    """A line in the FST text (or symbol table) could not be parsed."""


def load_symbols(path: str) -> Dict[str, int]:
    """OpenFST symbol table: ``symbol id`` per line (# comments allowed)."""
    syms: Dict[str, int] = {}
    with open(path, "r", encoding="utf-8") as f:
        for lineno, ln in enumerate(f, 1):
            ln = ln.strip()
            if not ln or ln.startswith("#"):
                continue
            parts = ln.split()
            if len(parts) != 2:
                raise FstFormatError(
                    f"{path}:{lineno}: expected 'symbol id', got {ln!r}")
            try:
                syms[parts[0]] = int(parts[1])
            except ValueError:
                raise FstFormatError(
                    f"{path}:{lineno}: non-integer id {parts[1]!r}") from None
    return syms


def _parse_fst_text(text: str, acceptor: Optional[bool]):
    """-> (start, arcs [(src, dst, ilabel, logp)], finals {state: logp}).

    Weights in the file are tropical costs; returned as negated log-probs.
    ``acceptor=None`` auto-detects: any 5-field line means transducer
    (src dst il ol w); otherwise 4-field lines are read as acceptor-with-
    weight (``fstprint --acceptor`` output), the common case for decoding
    graphs.
    """
    rows: List[Tuple[int, List[str]]] = []
    for lineno, ln in enumerate(text.splitlines(), 1):
        ln = ln.strip()
        if not ln or ln.startswith("#"):
            continue
        rows.append((lineno, ln.split()))
    if not rows:
        raise FstFormatError("empty FST text")
    if acceptor is None:
        acceptor = not any(len(p) == 5 for _, p in rows)
    arcs: List[Tuple[int, int, int, float]] = []
    finals: Dict[int, float] = {}
    start: Optional[int] = None

    def _int(lineno, s, what):
        try:
            return int(s)
        except ValueError:
            raise FstFormatError(
                f"line {lineno}: non-integer {what} {s!r}") from None

    def _float(lineno, s):
        try:
            return float(s)
        except ValueError:
            raise FstFormatError(
                f"line {lineno}: non-numeric weight {s!r}") from None

    for lineno, p in rows:
        if len(p) <= 2:  # final-state line
            st = _int(lineno, p[0], "state")
            cost = _float(lineno, p[1]) if len(p) == 2 else 0.0
            prev = finals.get(st, NEG_INF)
            finals[st] = max(prev, -cost)
            if start is None:
                start = st
            continue
        if len(p) > 5 or (acceptor and len(p) == 5):
            raise FstFormatError(f"line {lineno}: too many fields ({len(p)})")
        src = _int(lineno, p[0], "src state")
        dst = _int(lineno, p[1], "dst state")
        il = _int(lineno, p[2], "ilabel")
        if acceptor:
            cost = _float(lineno, p[3]) if len(p) == 4 else 0.0
        else:
            if len(p) < 4:
                raise FstFormatError(
                    f"line {lineno}: transducer arc needs an olabel")
            _int(lineno, p[3], "olabel")  # validated, then ignored
            cost = _float(lineno, p[4]) if len(p) == 5 else 0.0
        arcs.append((src, dst, il, -cost))
        if start is None:
            start = src
    return start, arcs, finals


def _eps_closure(subset: Dict[int, float],
                 eps: Dict[int, List[Tuple[int, float]]],
                 n_states: int) -> Dict[int, float]:
    """Max-plus closure over epsilon arcs (exact; rejects gain cycles)."""
    out = dict(subset)
    frontier = list(subset.items())
    rounds = 0
    while frontier:
        rounds += 1
        if rounds > n_states + 1:
            raise FstFormatError(
                "epsilon cycle with positive weight (score diverges)")
        nxt: Dict[int, float] = {}
        for s, w in frontier:
            for t, ew in eps.get(s, ()):
                cand = w + ew
                if cand > out.get(t, NEG_INF) + 1e-12:
                    out[t] = cand
                    nxt[t] = cand
        frontier = list(nxt.items())
    return out


def _canon(subset: Dict[int, float]) -> Tuple[Tuple[int, float], ...]:
    return tuple(sorted((s, round(w, 9)) for s, w in subset.items()))


def token_trie_from_openfst_text(
        text: str, vocab_size: int, *,
        acceptor: Optional[bool] = None,
        isymbols: Optional[Dict[str, int]] = None,
        vocab=None,
        eps_id: Optional[int] = None) -> TokenTrie:
    """Compile OpenFST text into a dense :class:`TokenTrie`.

    ``isymbols`` + ``vocab``: arc labels are symbol-table ids; each symbol
    string is mapped to its vocab token id (``vocab.get_id`` exact
    match); the ``<eps>`` symbol is epsilon. Without a symbol table,
    labels are raw token ids; pass ``eps_id`` to designate one id (usually
    0 in graphs that follow the OpenFST convention) as epsilon.

    Weighted determinization is exact over the tropical (max,+) semiring,
    so the best-path weight of every token sequence is preserved — the
    property beam search actually consumes.
    """
    start, raw_arcs, finals = _parse_fst_text(text, acceptor)

    label_to_token: Optional[Dict[int, int]] = None
    eps_labels = set()
    if isymbols is not None:
        if vocab is None:
            raise ValueError("isymbols requires vocab to map symbols to "
                             "token ids")
        label_to_token = {}
        for sym, sid in isymbols.items():
            if sym in ("<eps>", "<epsilon>"):
                eps_labels.add(sid)
                continue
            tok = vocab.get_id(sym)
            if tok is None:
                raise FstFormatError(
                    f"FST symbol {sym!r} is not in the vocabulary")
            label_to_token[sid] = tok
    elif eps_id is not None:
        eps_labels.add(eps_id)

    # NFA adjacency: state -> {token: [(dst, logp)]}, eps arcs separate
    states = {start, *finals}
    arcs: Dict[int, Dict[int, List[Tuple[int, float]]]] = {}
    eps: Dict[int, List[Tuple[int, float]]] = {}
    for src, dst, il, w in raw_arcs:
        states.add(src)
        states.add(dst)
        if il in eps_labels:
            eps.setdefault(src, []).append((dst, w))
            continue
        if label_to_token is not None:
            if il not in label_to_token:
                raise FstFormatError(
                    f"arc label {il} missing from the symbol table")
            tok = label_to_token[il]
        else:
            tok = il
        if not 0 <= tok < vocab_size:
            raise FstFormatError(
                f"token id {tok} out of range for vocab_size {vocab_size}")
        arcs.setdefault(src, {}).setdefault(tok, []).append((dst, w))
    n_nfa = len(states)

    # weighted subset construction (tropical max-plus, exact via residuals)
    start_subset = _eps_closure({start: 0.0}, eps, n_nfa)
    start_shift = max(start_subset.values())
    start_subset = {s: w - start_shift for s, w in start_subset.items()}
    key0 = _canon(start_subset)
    index: Dict[Tuple, int] = {key0: 0}
    members: List[Dict[int, float]] = [start_subset]
    table_rows: List[Dict[int, Tuple[int, float]]] = []
    queue = [0]
    while queue:
        i = queue.pop()
        while len(table_rows) <= i:
            table_rows.append({})
        sub = members[i]
        by_tok: Dict[int, Dict[int, float]] = {}
        for s, r in sub.items():
            for tok, outs in arcs.get(s, {}).items():
                dests = by_tok.setdefault(tok, {})
                for t, w in outs:
                    cand = r + w
                    if cand > dests.get(t, NEG_INF):
                        dests[t] = cand
        for tok, dests in by_tok.items():
            dests = _eps_closure(dests, eps, n_nfa)
            m = max(dests.values())
            nxt = {t: w - m for t, w in dests.items()}
            key = _canon(nxt)
            j = index.get(key)
            if j is None:
                j = len(members)
                if j >= MAX_DFA_STATES:
                    raise FstFormatError(
                        f"determinized graph exceeds {MAX_DFA_STATES} "
                        f"states — simplify the FST")
                index[key] = j
                members.append(nxt)
                queue.append(j)
            table_rows[i][tok] = (j, m)

    n = len(members)
    next_state = np.full((n, vocab_size), -1, np.int32)
    arc_weight = np.zeros((n, vocab_size), np.float32)
    is_final = np.zeros((n,), bool)
    final_weight = np.zeros((n,), np.float32)
    for i, row in enumerate(table_rows):
        for tok, (j, w) in row.items():
            next_state[i, tok] = j
            arc_weight[i, tok] = w
    for i, sub in enumerate(members):
        best = NEG_INF
        for s, r in sub.items():
            if s in finals:
                best = max(best, r + finals[s])
        if best > NEG_INF:
            is_final[i] = True
            # start_shift is a constant on every accepted path; realizing
            # it at acceptance keeps total path weights exact
            final_weight[i] = best + start_shift
    return TokenTrie.from_tables(next_state, is_final,
                                 arc_weight=arc_weight,
                                 final_weight=final_weight)


def token_trie_from_openfst_file(path: str, vocab_size: int, *,
                                 vocab=None,
                                 acceptor: Optional[bool] = None,
                                 eps_id: Optional[int] = None,
                                 symbols_path: Optional[str] = None
                                 ) -> TokenTrie:
    """File variant; auto-discovers a sibling ``<stem>.syms`` table."""
    import os

    if symbols_path is None:
        stem = path
        for suf in (".fst.txt", ".fsttxt", ".fst", ".txt"):
            if stem.endswith(suf):
                stem = stem[: -len(suf)]
                break
        cand = stem + ".syms"
        symbols_path = cand if os.path.exists(cand) else None
    isymbols = load_symbols(symbols_path) if symbols_path else None
    with open(path, "r", encoding="utf-8") as f:
        text = f.read()
    return token_trie_from_openfst_text(
        text, vocab_size, acceptor=acceptor, isymbols=isymbols,
        vocab=vocab, eps_id=eps_id)
