// WordPiece tokenizer fast path (ASCII input).
//
// The port's copy of gstx/native/wordpiece.cc: the native equivalent of
// gstx_torch/data/tokenizer.py (which replaces the HF
// BertTokenizer the reference uses in every dataloader,
// dataloader_visdial_gen.py:60-63).  Handles the ASCII fast path — basic
// cleanup, lowercasing, punctuation splitting, greedy longest-match-first
// WordPiece; callers fall back to the Python tokenizer for non-ASCII text
// (VisDial/CC12M captions are overwhelmingly ASCII).  Output ids match the
// Python implementation exactly (tests/test_torch_port_data.py),
// including the cleanup semantics: ' ', \t, \n, \r are word boundaries;
// every other control byte (0x00-0x1f minus \t\n\r, and 0x7f) is DELETED
// exactly like tokenizer.py::_clean_text (cp==0 / _is_control ->
// dropped, not a boundary).
//
// C ABI (ctypes):
//   void* wp_load(const char* vocab_path);     // NULL on error
//   void  wp_free(void* handle);
//   int   wp_vocab_size(void* handle);
//   int   wp_encode(void* handle, const char* text, int text_len,
//                   int* out_ids, int cap);
//         // Returns the TOTAL number of ids the text produces (which may
//         // exceed cap — only min(total, cap) are written; the caller
//         // must regrow its buffer and retry when total > cap), or -1 if
//         // the text has non-ASCII bytes (caller must fall back).
//         // text_len is explicit so embedded NUL bytes are handled like
//         // the Python path (deleted) instead of truncating the text.

#include <cctype>
#include <cstring>
#include <fstream>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct Vocab {
  std::unordered_map<std::string, int> table;
  int unk_id = 100;
  static constexpr int kMaxCharsPerWord = 100;
};

bool is_ascii_punct(char c) {
  unsigned char u = static_cast<unsigned char>(c);
  return (u >= 33 && u <= 47) || (u >= 58 && u <= 64) ||
         (u >= 91 && u <= 96) || (u >= 123 && u <= 126);
}

// greedy longest-match-first subword split (tokenizer.py WordPieceTokenizer)
void wordpiece(const Vocab& v, const std::string& word,
               std::vector<int>* out) {
  if (word.size() > Vocab::kMaxCharsPerWord) {
    out->push_back(v.unk_id);
    return;
  }
  std::vector<int> pieces;
  size_t start = 0;
  while (start < word.size()) {
    size_t end = word.size();
    int cur = -1;
    while (start < end) {
      std::string sub = word.substr(start, end - start);
      if (start > 0) sub = "##" + sub;
      auto it = v.table.find(sub);
      if (it != v.table.end()) {
        cur = it->second;
        break;
      }
      --end;
    }
    if (cur < 0) {
      out->push_back(v.unk_id);
      return;
    }
    pieces.push_back(cur);
    start = end;
  }
  out->insert(out->end(), pieces.begin(), pieces.end());
}

}  // namespace

extern "C" {

void* wp_load(const char* vocab_path) {
  std::ifstream f(vocab_path);
  if (!f.good()) return nullptr;
  auto* v = new Vocab();
  std::string line;
  int idx = 0;
  while (std::getline(f, line)) {
    if (!line.empty() && line.back() == '\r') line.pop_back();
    if (!line.empty()) v->table[line] = idx;
    ++idx;
  }
  auto it = v->table.find("[UNK]");
  if (it == v->table.end()) {
    delete v;
    return nullptr;
  }
  v->unk_id = it->second;
  return v;
}

void wp_free(void* handle) { delete static_cast<Vocab*>(handle); }

int wp_vocab_size(void* handle) {
  return static_cast<int>(static_cast<Vocab*>(handle)->table.size());
}

int wp_encode(void* handle, const char* text, int text_len, int* out_ids,
              int cap) {
  const Vocab& v = *static_cast<Vocab*>(handle);
  const size_t len = text_len < 0 ? 0 : static_cast<size_t>(text_len);
  // ASCII gate: non-ASCII goes to the Python slow path
  for (size_t i = 0; i < len; ++i) {
    if (static_cast<unsigned char>(text[i]) > 127) return -1;
  }

  std::vector<int> ids;
  std::string word;
  auto flush_word = [&]() {
    if (!word.empty()) {
      wordpiece(v, word, &ids);
      word.clear();
    }
  };
  for (size_t i = 0; i < len; ++i) {
    char c = text[i];
    unsigned char u = static_cast<unsigned char>(c);
    if (c == ' ' || c == '\t' || c == '\n' || c == '\r') {
      flush_word();
      continue;
    }
    if (u < 0x20 || u == 0x7f) {
      // control chars (incl. NUL, \v, \f) are DELETED, not boundaries —
      // tokenizer.py:81 drops them before word splitting
      continue;
    }
    c = static_cast<char>(std::tolower(u));
    if (is_ascii_punct(c)) {
      flush_word();
      word.push_back(c);
      flush_word();
      continue;
    }
    word.push_back(c);
  }
  flush_word();

  const size_t total = ids.size();
  const size_t n = total < static_cast<size_t>(cap)
                       ? total
                       : static_cast<size_t>(cap);
  for (size_t i = 0; i < n; ++i) out_ids[i] = ids[i];
  return static_cast<int>(total);
}

}  // extern "C"
