// Native WordPiece batch encoder.
//
// C++ twin of mmd_tpu_torch/data/tokenizer.py's encode hot loop (the reference
// leaned on HF tokenizers' Rust for this; see reference requirements.txt:18
// sentencepiece and train.py:136-140). Same algorithm, same output:
// lowercase+NFKC-lite normalization, \w+|punct word split, greedy
// longest-match-first WordPiece with "##" continuations, [CLS]...[SEP]
// framing, fixed-length int32 ids + attention mask.
//
// Exposed as a C ABI for ctypes (no pybind11 in this image). Thread-parallel
// over the batch with std::thread.
//
// Built with g++ at first use by mmd_tpu_torch/native/bindings.py (the
// port's copy of mmd_tpu/native/tokenizer.cpp).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

struct Vocab {
  std::unordered_map<std::string, int32_t> token_to_id;
  int32_t pad_id = 0, unk_id = 1, cls_id = 2, sep_id = 3;
  size_t max_token_len = 1;
};

// UTF-8-aware-enough lowercase for ASCII; multibyte sequences pass through.
inline void ascii_lower(std::string& s) {
  for (char& c : s) {
    if (c >= 'A' && c <= 'Z') c = static_cast<char>(c - 'A' + 'a');
  }
}

inline bool is_word_char(unsigned char c) {
  return (c >= 'a' && c <= 'z') || (c >= 'A' && c <= 'Z') ||
         (c >= '0' && c <= '9') || c == '_' || c >= 0x80;
}

inline bool is_space(unsigned char c) {
  return c == ' ' || c == '\t' || c == '\n' || c == '\r' || c == '\f' ||
         c == '\v';
}

// Python parity: re.findall(r"\w+|[^\w\s]", text.lower())
std::vector<std::string> basic_tokenize(const std::string& text) {
  std::string t = text;
  ascii_lower(t);
  std::vector<std::string> words;
  size_t i = 0, n = t.size();
  while (i < n) {
    unsigned char c = t[i];
    if (is_space(c)) { ++i; continue; }
    if (is_word_char(c)) {
      size_t j = i;
      while (j < n && is_word_char(static_cast<unsigned char>(t[j]))) ++j;
      words.emplace_back(t.substr(i, j - i));
      i = j;
    } else {
      // single non-word, non-space char (multibyte: take the full sequence)
      size_t len = 1;
      if (c >= 0xF0) len = 4; else if (c >= 0xE0) len = 3; else if (c >= 0xC0) len = 2;
      words.emplace_back(t.substr(i, std::min(len, n - i)));
      i += len;
    }
  }
  return words;
}

void wordpiece(const Vocab& v, const std::string& word,
               std::vector<int32_t>& out) {
  static constexpr size_t kMaxChars = 64;
  if (word.size() > kMaxChars) { out.push_back(v.unk_id); return; }
  std::vector<int32_t> pieces;
  size_t start = 0;
  while (start < word.size()) {
    size_t end = word.size();
    int32_t cur = -1;
    while (start < end) {
      std::string piece = word.substr(start, end - start);
      if (start > 0) piece = "##" + piece;
      auto it = v.token_to_id.find(piece);
      if (it != v.token_to_id.end()) { cur = it->second; break; }
      --end;
    }
    if (cur < 0) { out.push_back(v.unk_id); return; }
    pieces.push_back(cur);
    start = end;
  }
  out.insert(out.end(), pieces.begin(), pieces.end());
}

void encode_one(const Vocab& v, const char* text, int32_t max_length,
                int32_t* ids, int32_t* mask) {
  std::vector<int32_t> out;
  out.reserve(max_length);
  out.push_back(v.cls_id);
  for (const auto& w : basic_tokenize(text ? text : "")) {
    wordpiece(v, w, out);
    if (out.size() >= static_cast<size_t>(max_length)) break;
  }
  if (out.size() > static_cast<size_t>(max_length - 1))
    out.resize(max_length - 1);
  out.push_back(v.sep_id);
  for (int32_t i = 0; i < max_length; ++i) {
    if (i < static_cast<int32_t>(out.size())) {
      ids[i] = out[i];
      mask[i] = 1;
    } else {
      ids[i] = v.pad_id;
      mask[i] = 0;
    }
  }
}

}  // namespace

extern "C" {

// vocab_blob: '\n'-joined tokens in id order. Returns an opaque handle.
void* mmdtok_create(const char* vocab_blob, int64_t blob_len,
                    int32_t pad_id, int32_t unk_id, int32_t cls_id,
                    int32_t sep_id) {
  auto* v = new Vocab();
  v->pad_id = pad_id; v->unk_id = unk_id; v->cls_id = cls_id; v->sep_id = sep_id;
  std::string blob(vocab_blob, static_cast<size_t>(blob_len));
  size_t start = 0;
  int32_t id = 0;
  while (start <= blob.size()) {
    size_t nl = blob.find('\n', start);
    if (nl == std::string::npos) nl = blob.size();
    std::string tok = blob.substr(start, nl - start);
    if (!tok.empty()) {
      v->token_to_id.emplace(tok, id);
      v->max_token_len = std::max(v->max_token_len, tok.size());
    }
    ++id;
    if (nl == blob.size()) break;
    start = nl + 1;
  }
  return v;
}

void mmdtok_destroy(void* handle) { delete static_cast<Vocab*>(handle); }

// texts: '\0'-separated batch of n strings. ids/mask: (n, max_length) int32.
void mmdtok_encode_batch(void* handle, const char* texts, int64_t /*texts_len*/,
                         int32_t n, int32_t max_length,
                         int32_t* ids, int32_t* mask, int32_t num_threads) {
  const Vocab& v = *static_cast<Vocab*>(handle);
  std::vector<const char*> ptrs(n);
  const char* p = texts;
  for (int32_t i = 0; i < n; ++i) {
    ptrs[i] = p;
    p += std::strlen(p) + 1;
  }
  int32_t nt = std::max(1, std::min(num_threads, n));
  std::vector<std::thread> threads;
  threads.reserve(nt);
  for (int32_t t = 0; t < nt; ++t) {
    threads.emplace_back([&, t]() {
      for (int32_t i = t; i < n; i += nt) {
        encode_one(v, ptrs[i], max_length,
                   ids + static_cast<int64_t>(i) * max_length,
                   mask + static_cast<int64_t>(i) * max_length);
      }
    });
  }
  for (auto& th : threads) th.join();
}

}  // extern "C"
