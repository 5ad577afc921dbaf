// Chinese word segmenter: jieba's default cut (`jieba.cut(text, HMM=True)`,
// jieba 0.42.1) in C++.
//
// Native-code counterpart of the reference's `rjieba` dependency (a Rust
// extension used at src/f5_tts/model/utils.py:10,162), and the port's copy
// of the JAX package's f5tts_tpu/native/segmenter.cc, whose cut departs from
// jieba on ASCII runs (it keeps "bank." whole, where jieba cuts "bank" and
// "."; it never forms a dictionary word of ASCII and CJK, such as "T恤").
// This copy follows jieba step for step:
//   1. the text splits into blocks of CJK (U+4E00-U+9FD5) and ASCII
//      [a-zA-Z0-9+#&._%-] characters (jieba's re_han_default); between
//      them, "\r\n" and every other character is a segment of its own;
//   2. a block's DAG holds, at each position, the ends of the dictionary
//      words (freq > 0) that start there, else the position itself
//      (get_DAG); the most probable path runs right to left, a word
//      scoring log(freq) - log(total) (log(1) - log(total) outside the
//      dictionary), ties to the longer word (calc);
//   3. runs of one-character steps that are no dictionary word go through
//      jieba.finalseg: CJK runs through the BMES Viterbi (its tie rules and
//      legal transitions), other runs split on [a-zA-Z0-9]+(\.\d+)?%?.
// The dictionary is jieba's dict.txt ("word freq [pos]" lines), the HMM
// tables a TSV of jieba.finalseg's (segmenter.py writes both).
//
// Exposed as a C ABI for ctypes (see segmenter.py). Thread-safe after init.

#include <array>
#include <cstdint>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>
#include <cmath>
#include <cstdio>
#include <mutex>

namespace {

struct Dict {
  std::unordered_map<std::string, double> logfreq;  // word -> log(freq/total)
  // set of all prefixes of dictionary words (jieba's trie replacement):
  // prefix present with flag=false means "extendable but not a word".
  std::unordered_map<std::string, bool> prefixes;
  double total_log = 0.0;
  bool loaded = false;
};

Dict g_dict;
std::mutex g_mutex;

// HMM (BMES) tables for OOV segmentation, jieba finalseg semantics.
struct Hmm {
  // state order: B=0, M=1, E=2, S=3
  double start[4];
  double trans[4][4];                              // log prob, MIN if illegal
  std::unordered_map<std::string, double> emit[4]; // codepoint -> log prob
  bool loaded = false;
};

constexpr double kMinProb = -3.14e100;
Hmm g_hmm;

int StateIdx(char c) {
  switch (c) {
    case 'B': return 0;
    case 'M': return 1;
    case 'E': return 2;
    case 'S': return 3;
  }
  return -1;
}

// Decode UTF-8 into per-codepoint byte spans.
std::vector<std::pair<int, int>> Codepoints(const char* s, int len) {
  std::vector<std::pair<int, int>> out;
  int i = 0;
  while (i < len) {
    unsigned char c = s[i];
    int n = 1;
    if ((c & 0x80) == 0x00) n = 1;
    else if ((c & 0xE0) == 0xC0) n = 2;
    else if ((c & 0xF0) == 0xE0) n = 3;
    else if ((c & 0xF8) == 0xF0) n = 4;
    if (i + n > len) n = 1;
    out.emplace_back(i, n);
    i += n;
  }
  return out;
}

}  // namespace

extern "C" {

// Load dict.txt ("word freq [pos]" lines). Returns word count, -1 on error.
int seg_load_dict(const char* path) {
  std::lock_guard<std::mutex> lock(g_mutex);
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  g_dict.logfreq.clear();
  g_dict.prefixes.clear();
  double total = 0.0;
  char line[4096];
  std::vector<std::pair<std::string, double>> entries;
  while (fgets(line, sizeof(line), f)) {
    char word[1024];
    double freq = 0.0;
    if (sscanf(line, "%1023s %lf", word, &freq) >= 2 && freq > 0) {
      entries.emplace_back(word, freq);
      total += freq;
    }
  }
  fclose(f);
  if (entries.empty() || total <= 0) return -1;
  g_dict.total_log = std::log(total);
  for (auto& [word, freq] : entries) {
    double lf = std::log(freq) - g_dict.total_log;
    g_dict.logfreq[word] = lf;
    // register all codepoint-prefixes
    auto cps = Codepoints(word.c_str(), (int)word.size());
    for (size_t k = 1; k < cps.size(); ++k) {
      std::string pref = word.substr(0, cps[k].first);
      g_dict.prefixes.emplace(pref, false);
    }
    g_dict.prefixes[word] = true;
  }
  g_dict.loaded = true;
  return (int)entries.size();
}

// Load HMM tables from a TSV ("S <state> <logp>" / "T <from> <to> <logp>" /
// "E <state> <utf8-char> <logp>"). Returns emission count, -1 on error.
int seg_load_hmm(const char* path) {
  std::lock_guard<std::mutex> lock(g_mutex);
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  for (int i = 0; i < 4; ++i) {
    g_hmm.start[i] = kMinProb;
    g_hmm.emit[i].clear();
    for (int j = 0; j < 4; ++j) g_hmm.trans[i][j] = kMinProb;
  }
  char line[512];
  int count = 0;
  while (fgets(line, sizeof(line), f)) {
    char a, b;
    double p;
    char token[64];
    if (line[0] == 'T' && sscanf(line, "T %c %c %lf", &a, &b, &p) == 3) {
      int i = StateIdx(a), j = StateIdx(b);
      if (i >= 0 && j >= 0) g_hmm.trans[i][j] = p;
    } else if (line[0] == 'S' && sscanf(line, "S %c %lf", &a, &p) == 2) {
      int i = StateIdx(a);
      if (i >= 0) g_hmm.start[i] = p;
    } else if (line[0] == 'E' && sscanf(line, "E %c %63s %lf", &a, token, &p) == 3) {
      int i = StateIdx(a);
      if (i >= 0) {
        g_hmm.emit[i][token] = p;
        ++count;
      }
    }
  }
  fclose(f);
  g_hmm.loaded = count > 0;
  return count;
}

}  // extern "C"

namespace {

// One code point of the text: its bytes [b, b + n) and its value.
struct Cp {
  int b, n;
  uint32_t u;
};

std::vector<Cp> Decode(const char* s, int len) {
  std::vector<Cp> out;
  for (auto [b, n] : Codepoints(s, len)) {
    const unsigned char* p = (const unsigned char*)s + b;
    uint32_t u = p[0];
    if (n == 2) u = ((p[0] & 0x1Fu) << 6) | (p[1] & 0x3Fu);
    if (n == 3) u = ((p[0] & 0x0Fu) << 12) | ((p[1] & 0x3Fu) << 6) | (p[2] & 0x3Fu);
    if (n == 4) u = ((p[0] & 0x07u) << 18) | ((p[1] & 0x3Fu) << 12) | ((p[2] & 0x3Fu) << 6) |
                    (p[3] & 0x3Fu);
    out.push_back({b, n, u});
  }
  return out;
}

bool IsCjk(uint32_t u) { return u >= 0x4E00 && u <= 0x9FD5; }  // finalseg's re_han
bool IsAsciiAlnum(uint32_t u) {
  return (u >= 'a' && u <= 'z') || (u >= 'A' && u <= 'Z') || (u >= '0' && u <= '9');
}
bool IsDigit(uint32_t u) { return u >= '0' && u <= '9'; }
// jieba's re_han_default: [一-鿕a-zA-Z0-9+#&\._%\-]
bool InBlock(uint32_t u) {
  return IsCjk(u) || IsAsciiAlnum(u) || u == '+' || u == '#' || u == '&' || u == '.' ||
         u == '_' || u == '%' || u == '-';
}

// Writes '\x01'-separated segments; false once `cap` bytes would overflow.
struct Out {
  const char* text;
  char* out;
  int cap, w = 0, count = 0;
  bool Emit(int b0, int b1) {
    int len = b1 - b0;
    if (w + len + 2 > cap) return false;
    if (count > 0) out[w++] = '\x01';
    memcpy(out + w, text + b0, len);
    w += len;
    ++count;
    return true;
  }
  bool Span(const Cp* c, int i, int j) { return Emit(c[i].b, c[j - 1].b + c[j - 1].n); }
};

std::string Bytes(const char* text, const Cp* c, int i, int j) {
  return std::string(text + c[i].b, c[j - 1].b + c[j - 1].n - c[i].b);
}

// jieba.finalseg's Viterbi over a CJK run c[0, n), and its __cut.
// States B=0, M=1, E=2, S=3; PrevStatus B<-(E,S), M<-(M,B), E<-(B,M),
// S<-(S,E). A tie goes to the previous state whose letter is greater, and
// at the end to S, as Python's max over (prob, state) tuples.
bool ViterbiCut(const char* text, const Cp* c, int n, Out& out) {
  static const int kPrev[4][2] = {{2, 3}, {1, 0}, {0, 1}, {3, 2}};
  static const char kLetter[4] = {'B', 'M', 'E', 'S'};
  std::vector<std::array<double, 4>> v(n);
  std::vector<std::array<int, 4>> back(n);
  auto emitp = [&](int s, int i) {
    auto it = g_hmm.emit[s].find(std::string(text + c[i].b, c[i].n));
    return it != g_hmm.emit[s].end() ? it->second : kMinProb;
  };
  for (int s = 0; s < 4; ++s) v[0][s] = g_hmm.start[s] + emitp(s, 0);
  for (int i = 1; i < n; ++i) {
    for (int s = 0; s < 4; ++s) {
      double em = emitp(s, i), best = 0.0;
      int bj = -1;
      for (int j : kPrev[s]) {
        double cand = v[i - 1][j] + g_hmm.trans[j][s] + em;
        if (bj < 0 || cand > best || (cand == best && kLetter[j] > kLetter[bj])) {
          best = cand;
          bj = j;
        }
      }
      v[i][s] = best;
      back[i][s] = bj;
    }
  }
  int s = v[n - 1][2] > v[n - 1][3] ? 2 : 3;
  std::vector<int> states(n);
  for (int i = n - 1; i >= 0; --i) {
    states[i] = s;
    if (i > 0) s = back[i][s];
  }
  int begin = 0, next = 0;
  for (int i = 0; i < n; ++i) {
    if (states[i] == 0) {
      begin = i;
    } else if (states[i] == 2) {
      if (!out.Span(c, begin, i + 1)) return false;
      next = i + 1;
    } else if (states[i] == 3) {
      if (!out.Span(c, i, i + 1)) return false;
      next = i + 1;
    }
  }
  return next >= n || out.Span(c, next, n);
}

// jieba.finalseg.cut of c[0, n): CJK runs through the Viterbi, the rest
// split on [a-zA-Z0-9]+(?:\.\d+)?%? (matches and the text between them).
bool FinalsegCut(const char* text, const Cp* c, int n, Out& out) {
  int p = 0;
  while (p < n) {
    int q = p;
    bool cjk = IsCjk(c[p].u);
    while (q < n && IsCjk(c[q].u) == cjk) ++q;
    if (cjk) {
      if (!ViterbiCut(text, c + p, q - p, out)) return false;
    } else {
      int chunk = p, r = p;
      while (r < q) {
        if (!IsAsciiAlnum(c[r].u)) {
          ++r;
          continue;
        }
        int e = r;
        while (e < q && IsAsciiAlnum(c[e].u)) ++e;
        if (e + 1 < q && c[e].u == '.' && IsDigit(c[e + 1].u)) {
          ++e;
          while (e < q && IsDigit(c[e].u)) ++e;
        }
        if (e < q && c[e].u == '%') ++e;
        if (chunk < r && !out.Span(c, chunk, r)) return false;
        if (!out.Span(c, r, e)) return false;
        r = chunk = e;
      }
      if (chunk < q && !out.Span(c, chunk, q)) return false;
    }
    p = q;
  }
  return true;
}

// jieba's __cut_DAG over one block c[0, n).
bool CutBlock(const char* text, const Cp* c, int n, Out& out) {
  std::vector<std::vector<int>> dag(n);  // get_DAG
  for (int k = 0; k < n; ++k) {
    std::string frag(text + c[k].b, c[k].n);
    for (int i = k; i < n;) {
      auto it = g_dict.prefixes.find(frag);
      if (it == g_dict.prefixes.end()) break;
      if (it->second) dag[k].push_back(i);
      if (++i < n) frag.append(text + c[i].b, c[i].n);
    }
    if (dag[k].empty()) dag[k].push_back(k);
  }
  std::vector<double> score(n + 1, 0.0);  // calc
  std::vector<int> route(n, 0);
  for (int idx = n - 1; idx >= 0; --idx) {
    double best = 0.0;
    int bx = -1;
    for (int x : dag[idx]) {
      auto it = g_dict.logfreq.find(Bytes(text, c, idx, x + 1));
      double s = (it != g_dict.logfreq.end() ? it->second : 0.0 - g_dict.total_log) +
                 score[x + 1];
      if (bx < 0 || s > best || (s == best && x > bx)) {
        best = s;
        bx = x;
      }
    }
    score[idx] = best;
    route[idx] = bx;
  }
  int buf = -1;  // start of the pending one-character steps
  auto flush = [&](int end) -> bool {
    if (buf < 0) return true;
    int b = buf;
    buf = -1;
    if (end - b == 1) return out.Span(c, b, end);
    if (g_dict.logfreq.count(Bytes(text, c, b, end)) || !g_hmm.loaded) {
      for (int i = b; i < end; ++i) {
        if (!out.Span(c, i, i + 1)) return false;
      }
      return true;
    }
    return FinalsegCut(text, c + b, end - b, out);
  };
  for (int x = 0; x < n;) {
    int y = route[x] + 1;
    if (y - x == 1) {
      if (buf < 0) buf = x;
    } else {
      if (!flush(x) || !out.Span(c, x, y)) return false;
    }
    x = y;
  }
  return flush(n);
}

}  // namespace

// Segment utf-8 `text` as jieba.cut(text, HMM=True); writes
// '\x01'-separated segments into out (cap bytes). Returns the number of
// segments, or -1 without a dictionary or on overflow.
extern "C" int seg_cut(const char* text, char* out, int cap) {
  if (!g_dict.loaded) return -1;
  auto c = Decode(text, (int)strlen(text));
  int n = (int)c.size();
  Out o{text, out, cap};
  for (int i = 0; i < n;) {
    int j = i;
    if (InBlock(c[i].u)) {
      while (j < n && InBlock(c[j].u)) ++j;
      if (!CutBlock(text, c.data() + i, j - i, o)) return -1;
    } else {
      j = (c[i].u == '\r' && i + 1 < n && c[i + 1].u == '\n') ? i + 2 : i + 1;
      if (!o.Span(c.data(), i, j)) return -1;
    }
    i = j;
  }
  if (o.w + 1 > cap) return -1;
  out[o.w] = 0;
  return o.count;
}
