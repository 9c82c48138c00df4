// SentencePiece-unigram encode hot loop: C++ twin of
// mmd_tpu_torch/data/spm.py::UnigramTokenizer (the reference gets Rust-speed SPM
// tokenization from HF `tokenizers`, reference requirements.txt:18 /
// train.py:136-140; this is the native equivalent for the DeBERTa path).
//
// Exact-parity contract with the Python implementation:
//   * input texts are ALREADY normalized + metaspace'd UTF-8 (normalization
//     stays in Python: NFKC via unicodedata is C-speed; the precompiled
//     charsmap has its own native port below);
//   * Viterbi maximizes summed piece scores over a byte-trie of encodable
//     pieces (types NORMAL=1 / USER_DEFINED=4), with a one-character
//     unknown candidate at unk_score, strict-improvement tie-breaking in
//     the same candidate order as the Python loop (starts ascending, ends
//     ascending, unk after pieces), double accumulation;
//   * consecutive unknowns fuse into one id;
//   * output layout: [CLS] + ids[:max_len-2... truncation exactly as
//     UnigramTokenizer.encode] + [SEP], pad_id fill, mask over the
//     occupied prefix, token_type_ids all zero (no-pair batches only —
//     pair batches stay on the Python path).
//
// C ABI only, built with g++ at first use and loaded via ctypes by
// mmd_tpu_torch/native/bindings.py (the port's copy of
// mmd_tpu/native/spm.cpp).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <limits>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct Edge {
    uint8_t byte;
    int32_t child;
};

struct Node {
    int32_t term_id = -1;      // piece id when a piece ends here
    double term_score = 0.0;
    int32_t edge_lo = 0;       // [lo, hi) into SpmModel::edges, sorted by byte
    int32_t edge_hi = 0;
};

struct SpmModel {
    std::vector<Node> nodes;   // node 0 = root
    std::vector<Edge> edges;
    int32_t unk_id, pad_id, cls_id, sep_id;
    double unk_score;
    int max_piece_bytes = 1;
};

// trie under construction: children as per-node maps, flattened afterwards
struct BuildNode {
    int32_t term_id = -1;
    double term_score = 0.0;
    std::unordered_map<uint8_t, int32_t> children;
};

int utf8_len(uint8_t lead) {
    if (lead < 0x80) return 1;
    if (lead < 0xE0) return 2;
    if (lead < 0xF0) return 3;
    return 4;
}

}  // namespace

extern "C" {

// pieces_blob: '\0'-joined UTF-8 pieces (n_pieces of them), in id order.
// scores: per-piece log-prob (double — matches Python float accumulation).
// types: spm SentencePiece.type per piece (NORMAL=1, USER_DEFINED=4 are
// encodable; everything else — UNKNOWN/CONTROL/UNUSED/BYTE — is not).
void* mmdspm_create(const char* pieces_blob, int64_t blob_len,
                    const double* scores, const int32_t* types,
                    int32_t n_pieces, int32_t unk_id, int32_t pad_id,
                    int32_t cls_id, int32_t sep_id, double unk_score) {
    auto* m = new SpmModel();
    m->unk_id = unk_id;
    m->pad_id = pad_id;
    m->cls_id = cls_id;
    m->sep_id = sep_id;
    m->unk_score = unk_score;

    std::vector<BuildNode> build(1);
    const char* p = pieces_blob;
    const char* end = pieces_blob + blob_len;
    for (int32_t i = 0; i < n_pieces && p < end; ++i) {
        size_t len = strnlen(p, end - p);
        const bool encodable =
            (types[i] == 1 || types[i] == 4) && len > 0;
        if (encodable) {
            if ((int)len > m->max_piece_bytes) m->max_piece_bytes = (int)len;
            int32_t node = 0;
            for (size_t j = 0; j < len; ++j) {
                uint8_t b = (uint8_t)p[j];
                auto it = build[node].children.find(b);
                if (it == build[node].children.end()) {
                    build.push_back(BuildNode());
                    it = build[node].children.emplace(
                        b, (int32_t)build.size() - 1).first;
                }
                node = it->second;
            }
            build[node].term_id = i;
            build[node].term_score = scores[i];
        }
        p += len + 1;
    }

    // flatten to sorted-edge arrays (cache-friendly binary-search traversal)
    m->nodes.resize(build.size());
    for (size_t n = 0; n < build.size(); ++n) {
        m->nodes[n].term_id = build[n].term_id;
        m->nodes[n].term_score = build[n].term_score;
        m->nodes[n].edge_lo = (int32_t)m->edges.size();
        std::vector<std::pair<uint8_t, int32_t>> kids(
            build[n].children.begin(), build[n].children.end());
        std::sort(kids.begin(), kids.end());
        for (auto& kv : kids) m->edges.push_back({kv.first, kv.second});
        m->nodes[n].edge_hi = (int32_t)m->edges.size();
    }
    return m;
}

void mmdspm_destroy(void* h) { delete (SpmModel*)h; }

namespace {

inline int32_t trie_step(const SpmModel& m, int32_t node, uint8_t b) {
    const Node& nd = m.nodes[node];
    int lo = nd.edge_lo, hi = nd.edge_hi;
    while (lo < hi) {
        int mid = (lo + hi) / 2;
        if (m.edges[mid].byte < b) lo = mid + 1;
        else hi = mid;
    }
    return (lo < nd.edge_hi && m.edges[lo].byte == b) ? m.edges[lo].child : -1;
}

// Viterbi over bytes; byte positions are reachable only at character
// boundaries (pieces are whole UTF-8 strings, unk advances one char), so
// byte-space DP picks the identical segmentation as the Python
// code-point-space DP, with identical candidate order and tie-breaking.
void viterbi(const SpmModel& m, const uint8_t* text, int n,
             std::vector<int32_t>& out_ids,
             std::vector<double>& best, std::vector<int32_t>& back_start,
             std::vector<int32_t>& back_id) {
    const double NEG = -std::numeric_limits<double>::infinity();
    best.assign(n + 1, NEG);
    back_start.assign(n + 1, -1);
    back_id.assign(n + 1, -1);
    best[0] = 0.0;
    for (int start = 0; start < n; ++start) {
        const double b0 = best[start];
        if (b0 == NEG) continue;
        int32_t node = 0;
        const int stop = std::min(n, start + m.max_piece_bytes);
        for (int endp = start; endp < stop; ++endp) {
            node = trie_step(m, node, text[endp]);
            if (node < 0) break;
            const Node& nd = m.nodes[node];
            if (nd.term_id >= 0) {
                const double cand = b0 + nd.term_score;
                if (cand > best[endp + 1]) {
                    best[endp + 1] = cand;
                    back_start[endp + 1] = start;
                    back_id[endp + 1] = nd.term_id;
                }
            }
        }
        // single-character unknown candidate (after the piece candidates
        // at this start — same order as the Python loop)
        const int adv = std::min(utf8_len(text[start]), n - start);
        const double cand = b0 + m.unk_score;
        if (cand > best[start + adv]) {
            best[start + adv] = cand;
            back_start[start + adv] = start;
            back_id[start + adv] = m.unk_id;
        }
    }
    out_ids.clear();
    int pos = n;
    while (pos > 0) {
        out_ids.push_back(back_id[pos]);
        pos = back_start[pos];
    }
    // reverse, then fuse consecutive unknowns in place (write cursor
    // never passes the read cursor going forward)
    std::reverse(out_ids.begin(), out_ids.end());
    int w = 0;
    for (size_t r = 0; r < out_ids.size(); ++r) {
        int32_t id = out_ids[r];
        if (id == m.unk_id && w > 0 && out_ids[w - 1] == m.unk_id) continue;
        out_ids[w++] = id;
    }
    out_ids.resize(w);
}

}  // namespace

// texts_blob: '\0'-joined UTF-8 texts (n of them), each already normalized
// and metaspace'd ("▁" prefix + space replacement done by the caller; an
// empty string means "no tokens"). Outputs are (n, max_len) row-major
// int32: ids (pad-filled), mask, token_type_ids (all zero).
void mmdspm_encode_batch(void* h, const char* texts_blob, int64_t blob_len,
                         int32_t n, int32_t max_len, int32_t* out_ids,
                         int32_t* out_mask, int32_t* out_types) {
    const SpmModel& m = *(SpmModel*)h;
    std::vector<int32_t> ids;
    std::vector<double> best;
    std::vector<int32_t> back_start, back_id;
    const char* p = texts_blob;
    const char* end = texts_blob + blob_len;
    for (int32_t i = 0; i < n; ++i) {
        size_t len = (p < end) ? strnlen(p, end - p) : 0;
        ids.clear();
        if (len > 0)
            viterbi(m, (const uint8_t*)p, (int)len, ids, best, back_start,
                    back_id);
        p += len + 1;

        // layout per UnigramTokenizer.encode: [CLS]+ids, truncate to
        // max_len-1, append [SEP]
        int32_t* row_ids = out_ids + (int64_t)i * max_len;
        int32_t* row_mask = out_mask + (int64_t)i * max_len;
        int32_t* row_types = out_types + (int64_t)i * max_len;
        int used = 0;
        row_ids[used++] = m.cls_id;
        for (size_t j = 0; j < ids.size() && used < max_len - 1; ++j)
            row_ids[used++] = ids[j];
        row_ids[used++] = m.sep_id;
        for (int j = 0; j < used; ++j) row_mask[j] = 1;
        for (int j = used; j < max_len; ++j) {
            row_ids[j] = m.pad_id;
            row_mask[j] = 0;
        }
        memset(row_types, 0, sizeof(int32_t) * max_len);
    }
}

// ---------------------------------------------------------------------------
// Precompiled charsmap (nmt_nfkc) normalization — native port of
// spm.py::PrecompiledCharsmap.normalize (darts-clone double-array longest
// prefix match; sentencepiece normalizer.cc::NormalizePrefix semantics).
// blob: <uint32 LE trie_size><trie uint32 units><'\0'-separated pool>.
// Returns bytes written, or -1 when out_cap is too small (caller retries
// with a bigger buffer), or -2 on a corrupt blob.
// ---------------------------------------------------------------------------

int64_t mmdspm_charsmap_normalize(const uint8_t* blob, int64_t blob_len,
                                  const uint8_t* text, int64_t text_len,
                                  uint8_t* out, int64_t out_cap) {
    if (blob_len < 4) return -2;
    uint32_t trie_bytes;
    memcpy(&trie_bytes, blob, 4);
    if (trie_bytes % 4 != 0 || 4 + (int64_t)trie_bytes > blob_len) return -2;
    const uint32_t* units = (const uint32_t*)(blob + 4);
    const int64_t n_units = trie_bytes / 4;
    const uint8_t* pool = blob + 4 + trie_bytes;
    const int64_t pool_len = blob_len - 4 - trie_bytes;

    auto offset = [](uint32_t u) -> uint32_t {
        return (u >> 10) << ((u & (1u << 9)) >> 6);
    };

    int64_t i = 0, w = 0;
    while (i < text_len) {
        // longest trie prefix of text[i:]
        int64_t upos = offset(units[0]);
        int64_t best_len = 0, best_val = -1;
        for (int64_t j = i; j < text_len; ++j) {
            upos ^= text[j];
            if (upos >= n_units) break;
            const uint32_t u = units[upos];
            if ((u & ((1u << 31) | 0xFFu)) != text[j]) break;
            upos ^= offset(u);
            if ((u >> 8) & 1) {
                best_len = j - i + 1;
                best_val = (int64_t)(units[upos] & 0x7FFFFFFFu);
            }
        }
        if (best_len > 0) {
            if (best_val >= pool_len) return -2;
            const uint8_t* rep = pool + best_val;
            const uint8_t* repn =
                (const uint8_t*)memchr(rep, 0, pool_len - best_val);
            if (!repn) return -2;
            const int64_t rl = repn - rep;
            if (w + rl > out_cap) return -1;
            memcpy(out + w, rep, rl);
            w += rl;
            i += best_len;
        } else {
            const int64_t cl =
                std::min((int64_t)utf8_len(text[i]), text_len - i);
            if (w + cl > out_cap) return -1;
            memcpy(out + w, text + i, cl);
            w += cl;
            i += cl;
        }
    }
    return w;
}

}  // extern "C"
